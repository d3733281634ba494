"""Parity of the port's viscous incompressible solver,
Pyro("incompressible_viscous"), with pyro2_tpu, its moving lid at state and
multigrid level, the multigrid kernels' coverage of that lid, and the
cavity's golden.

The same inputs, made from a numpy seed or by each package's problem
module, go through the JAX functions (CPU, x64) and the port (CPU,
float64).  Tolerances:
  * initial data and ghost fills (BC.user at state level, MG._fill_v at
    every multigrid level): exact;
  * other_source_term: 1e-12 max|x| (the same float64 operations);
  * do_other_update_velocity (two Crank-Nicolson solves, proj_type 1 and
    2) and 5 cavity steps through Pyro: equal cycle counts in every solve
    and the state to 1e-12 max|x| (XLA multiplies by the smoother's
    reciprocal denominator where the port divides: a rounding a sweep);
  * the golden cavity_n64_Re400_0025.h5 (pyro2_tpu/test.py's
    incompressible_viscous run, 25 steps at 64^2): each variable over the
    valid region with numpy.allclose at rtol 1e-12, step count and time
    equal.

The multigrid's moving-lid fill is the trap of this solver: MG._fill_v
hands the registered function a stack whose one variable is "v", so the
lid's ghosts are 0.0 at multigrid level for the u solve as for the v solve;
only the state's own fill sets u = 1 there.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro2_tpu.solvers.incompressible_viscous.simulation as jsim_mod
import pyro2_tpu_torch.solvers.incompressible_viscous.simulation as tsim_mod
from pyro2_tpu import Pyro as JPyro
from pyro2_tpu.multigrid import MG as JMG
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.mesh import boundary as bnd
from pyro2_tpu_torch.multigrid import MG, mg_kernel
from pyro2_tpu_torch.multigrid import sharded_mg_kernel
from pyro2_tpu_torch.parallel import mesh_comm, sharded_mg
from pyro2_tpu_torch.pyro_sim import valid_solvers
from pyro2_tpu_torch.solvers.incompressible_viscous import BC
from pyro2_tpu_torch.util.carry import carry_simulation
from test_torch_burgers_viscous import cycles  # noqa: F401 (a fixture)

GOLDEN = (Path(__file__).resolve().parents[1] / "pyro2_tpu" / "solvers" /
          "incompressible_viscous" / "tests" / "cavity_n64_Re400_0025.h5")

CAVITY = ("dirichlet", "dirichlet", "dirichlet", "moving_lid")


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(ref, got, tol):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    err = np.abs(ref - got).max()
    assert err <= tol * np.abs(ref).max(), err


def _pair(problem, n=32, **inputs):
    inputs = {"mesh.nx": n, "mesh.ny": n, **inputs}
    pj = JPyro("incompressible_viscous")
    pj.initialize_problem(problem, inputs_dict=inputs)
    pt = Pyro("incompressible_viscous", device="cpu")
    pt.initialize_problem(problem, inputs_dict=inputs)
    return pj, pt


def _cavity_mg(n=32, beta=1e-3):
    """The u solve's multigrid of the cavity, as the solver builds it."""
    bnd.define_bc("moving_lid", BC.user, is_solid=False)
    xl, xr, yl, yr = CAVITY
    return MG.CellCenterMG2d(n, n, xl_BC_type=xl, xr_BC_type=xr,
                             yl_BC_type=yl, yr_BC_type=yr, alpha=1.0,
                             beta=beta, device="cpu")


# -- the solver ---------------------------------------------------------------

def test_incompressible_viscous_is_a_pyro_solver():
    assert "incompressible_viscous" in valid_solvers
    pt = Pyro("incompressible_viscous", device="cpu")
    pt.initialize_problem("cavity", inputs_dict={"mesh.nx": 8,
                                                 "mesh.ny": 8})
    d = pt.sim.cc_data
    assert d.get_aux("viscosity") == 0.0025
    assert d.BCs["x-velocity"].yrb == "moving_lid"
    assert bnd.ext_bcs["moving_lid"] is BC.user


@pytest.mark.parametrize("problem", ["cavity", "converge", "shear"])
def test_initial_data_matches_jax(problem, monkeypatch):
    """Each problem's state as its init_data sets it (preevolve's
    projection is held by the step tests)."""
    for mod in (jsim_mod, tsim_mod):
        monkeypatch.setattr(mod.Simulation, "preevolve", lambda self: None)
    pj, pt = _pair(problem)
    assert pt.sim.cc_data.names == pj.sim.cc_data.names
    assert np.array_equal(np.asarray(pj.sim.cc_data.data),
                          pt.sim.cc_data.data.numpy())


def test_lid_fill_at_state_level():
    """The state's fill: u = 1.0 and v = 0.0 in every top ghost row, the
    JAX package's fill bit for bit."""
    pj, pt = _pair("cavity", 16)
    rng = np.random.default_rng(1)
    U = rng.standard_normal(tuple(pt.sim.cc_data.data.shape))
    pj.sim.cc_data.data = jnp.asarray(U)
    pt.sim.cc_data.set_vars(U)
    pj.sim.cc_data.fill_BC_all()
    pt.sim.cc_data.fill_BC_all()
    assert np.array_equal(np.asarray(pj.sim.cc_data.data),
                          pt.sim.cc_data.data.numpy())
    g = pt.sim.cc_data.grid
    top = slice(g.jhi + 1, g.qy)
    assert bool((pt.get_var("x-velocity")[:, top] == 1.0).all())
    assert bool((pt.get_var("y-velocity")[:, top] == 0.0).all())


@pytest.mark.parametrize("component", ["x-velocity", "y-velocity"])
def test_lid_fill_at_multigrid_level_is_zero(component):
    """The C-N solve's multigrid of either component fills the lid's
    ghosts with 0.0 at every level (the shim's one variable is "v"), as
    the JAX package's multigrid does; writing 1.0 there for the u solve
    fails here."""
    from pyro2_tpu.mesh import boundary as jbnd
    from pyro2_tpu.solvers.incompressible_viscous import BC as JBC

    jbnd.define_bc("moving_lid", JBC.user, is_solid=False)
    pt = Pyro("incompressible_viscous", device="cpu")
    pt.initialize_problem("cavity", inputs_dict={"mesh.nx": 16,
                                                 "mesh.ny": 16})
    bcs = pt.sim.cc_data.BCs[component]
    kw = dict(xl_BC_type=bcs.xlb, xr_BC_type=bcs.xrb, yl_BC_type=bcs.ylb,
              yr_BC_type=bcs.yrb, alpha=1.0, beta=1e-3)
    tmg = MG.CellCenterMG2d(16, 16, device="cpu", **kw)
    jmg = JMG.CellCenterMG2d(16, 16, **kw)
    rng = np.random.default_rng(2)
    for level in range(tmg.nlevels):
        g = tmg.grids[level]
        v = rng.standard_normal((g.qx, g.qy))
        got = tmg._fill_v(level, torch.as_tensor(v))
        ref = np.asarray(jmg._fill_v(level, jnp.asarray(v)))
        assert np.array_equal(ref, got.numpy())
        assert bool((got[:, -1] == 0.0).all()), (component, level)
        assert not bool(torch.signbit(got[:, -1]).any())


def test_lid_refuses_other_edges_and_variables():
    pt = Pyro("incompressible_viscous", device="cpu")
    pt.initialize_problem("cavity", inputs_dict={"mesh.nx": 8,
                                                 "mesh.ny": 8})
    d = pt.sim.cc_data
    for edge in ("xlb", "xrb", "ylb"):
        with pytest.raises(RuntimeError, match="only implemented for 'yrb'"):
            BC.user("moving_lid", edge, "x-velocity", d, d.data.clone())
    with pytest.raises(RuntimeError, match="not supported"):
        BC.user("lid", "yrb", "x-velocity", d, d.data.clone())
    with pytest.raises(NotImplementedError, match="variable not defined"):
        BC.user("moving_lid", "yrb", "phi", d, d.data.clone())


def test_other_source_term_matches_jax():
    pj, pt = _pair("cavity", 16)
    rng = np.random.default_rng(3)
    U = rng.standard_normal(tuple(pt.sim.cc_data.data.shape))
    pj.sim.cc_data.data = jnp.asarray(U)
    pt.sim.cc_data.set_vars(U)
    for a, b in zip(pj.sim.other_source_term(), pt.sim.other_source_term()):
        _close(a, b, 1e-12)


@pytest.mark.parametrize("proj_type", [1, 2])
def test_do_other_update_velocity_matches_jax(proj_type, cycles):
    """The two C-N solves from the same state, MAC velocities and
    interface states (a numpy seed): the guess from w on buf=1, alpha 1,
    beta dt nu / 2, rtol 1e-12."""
    pj, pt = _pair("cavity", 32, **{"incompressible.proj_type": proj_type})
    rng = np.random.default_rng(4)
    shape = tuple(pt.sim.cc_data.data.shape)
    U = 0.3 * rng.standard_normal(shape)
    pj.sim.cc_data.data = jnp.asarray(U)
    pt.sim.cc_data.set_vars(U)
    pj.sim.cc_data.fill_BC_all()
    pt.sim.cc_data.fill_BC_all()
    fields = [0.3 * rng.standard_normal(shape[1:]) for _ in range(6)]
    pj.sim.dt = pt.sim.dt = 0.01
    counts = len(cycles["torch"])
    pj.sim.do_other_update_velocity(
        tuple(map(jnp.asarray, fields[:2])),
        tuple(map(jnp.asarray, fields[2:])))
    pt.sim.do_other_update_velocity(
        tuple(map(torch.as_tensor, fields[:2])),
        tuple(map(torch.as_tensor, fields[2:])))
    assert cycles["jax"][-2:] == cycles["torch"][-2:]
    assert len(cycles["torch"]) == counts + 2
    for name in ("x-velocity", "y-velocity"):
        _close(pj.sim.cc_data.get_var(name), pt.sim.cc_data.get_var(name),
               1e-12)


def test_cavity_steps_match_jax(cycles):
    pj, pt = _pair("cavity", 32)
    assert cycles["jax"] == cycles["torch"]        # preevolve's solves
    for _ in range(5):
        pj.single_step()
        pt.single_step()
        assert pt.sim.dt == pytest.approx(pj.sim.dt, rel=1e-12)
    assert pt.sim.n == pj.sim.n == 5
    assert cycles["jax"] == cycles["torch"]
    # preevolve's projection and throw-away step, then 4 solves a step
    assert len(cycles["torch"]) == 1 + 4 + 5 * 4
    for name in pt.sim.cc_data.names:
        _close(pj.sim.cc_data.get_var(name), pt.sim.cc_data.get_var(name),
               1e-12)


def test_a_carried_mid_run_cavity_steps_as_jax_does():
    pj, _ = _pair("cavity", 32)
    for _ in range(2):
        pj.single_step()
    jsim = pj.sim
    sim = carry_simulation("incompressible_viscous", "cavity",
                           jsim.rp.params, np.asarray(jsim.cc_data.data),
                           t=jsim.cc_data.t, n=jsim.n, device="cpu")
    sim.dt_old = jsim.dt_old        # the time loop's history, not state
    for s in (jsim, sim):
        s.cc_data.fill_BC_all()
        s.compute_timestep()
        s.evolve()
    assert sim.dt == pytest.approx(jsim.dt, rel=1e-12)
    for name in sim.cc_data.names:
        _close(jsim.cc_data.get_var(name), sim.cc_data.get_var(name), 1e-12)


def test_cavity_matches_golden():
    h5py = pytest.importorskip("h5py")
    p = Pyro("incompressible_viscous", device="cpu")
    p.initialize_problem("cavity", inputs_file="inputs.cavity", inputs_dict={
        "driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0})
    p.run_sim()
    g = p.get_grid()
    with h5py.File(GOLDEN, "r") as f:
        assert int(f.attrs["nsteps"]) == p.sim.n == 25
        assert float(f.attrs["time"]) == pytest.approx(p.sim.cc_data.t,
                                                       rel=1e-12)
        names = sorted(f["state"])
        assert names == sorted(p.sim.cc_data.names)
        for name in names:
            ref = f["state"][name]["data"][()]
            got = p.get_var(name)[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1].numpy()
            assert np.allclose(got, ref, rtol=1e-12), \
                (name, np.abs(got - ref).max())


# -- the multigrid kernels' coverage of the lid -------------------------------

def test_kernels_take_the_lid_on_yrb_as_zero():
    mg = _cavity_mg()
    assert mg_kernel.check(mg) == "const"
    assert mg_kernel.edge_kinds(mg.bc_v[-1]) == [1, 1, 1, mg_kernel.ZERO]
    assert mg_kernel.ZERO not in mg_kernel.BC_KIND.values()


@pytest.mark.parametrize("edge", ["xlb", "xrb", "ylb"])
def test_kernels_refuse_the_lid_on_another_edge(edge):
    bnd.define_bc("moving_lid", BC.user, is_solid=False)
    kinds = dict(zip(("xlb", "xrb", "ylb", "yrb"), ("dirichlet",) * 4))
    kinds[edge] = "moving_lid"
    mg = MG.CellCenterMG2d(16, 16, xl_BC_type=kinds["xlb"],
                           xr_BC_type=kinds["xrb"], yl_BC_type=kinds["ylb"],
                           yr_BC_type=kinds["yrb"], device="cpu")
    with pytest.raises(mg_kernel.Ineligible, match=r"ROADMAP\.md A\.26"):
        mg_kernel.check(mg)


def test_kernels_refuse_another_extended_bc(monkeypatch):
    def other(bc_name, bc_edge, variable, ccdata, stack):
        return stack

    monkeypatch.setitem(bnd.bc_solid, "sticky", False)
    monkeypatch.setitem(bnd.ext_bcs, "sticky", other)
    mg = MG.CellCenterMG2d(16, 16, yr_BC_type="sticky", device="cpu")
    with pytest.raises(mg_kernel.Ineligible, match=r"ROADMAP\.md A\.26"):
        mg_kernel.check(mg)


def test_kernels_refuse_a_reregistered_lid(monkeypatch):
    """The registry is a module-level dict: a "moving_lid" filled by
    another function than the port's own is another BC."""
    mg = _cavity_mg()

    def lid(bc_name, bc_edge, variable, ccdata, stack):
        return BC.user(bc_name, bc_edge, variable, ccdata, stack)

    monkeypatch.setitem(bnd.ext_bcs, "moving_lid", lid)
    with pytest.raises(mg_kernel.Ineligible, match=r"ROADMAP\.md A\.26"):
        mg_kernel.check(mg)


@pytest.mark.parametrize("op", ["vc", "general"])
def test_coefficient_kernels_refuse_the_lid(op):
    """The ZERO edge is the constant operator's: VarCoeffCCMG2d and
    GeneralMG2d under the lid raise on CUDA (their plain versions run it
    on the CPU)."""
    from test_torch_mg_up_tiles import make_mg

    mg = make_mg(op, 16, "cavity", torch.float64)
    with pytest.raises(mg_kernel.Ineligible, match=r"ROADMAP\.md A\.26"):
        mg_kernel.check(mg)


def test_the_sharded_path_keeps_its_kinds():
    """ZERO stays out of BC_KIND, from which the sharded kernels take their
    kinds, and ShardedMG refuses the lid."""
    assert mg_kernel.BC_KIND == {"outflow": 0, "neumann": 0,
                                 "reflect-even": 0, "dirichlet": 1,
                                 "reflect-odd": 1, "periodic": 2}
    assert sharded_mg_kernel.SUPPORTED_BCS == frozenset(mg_kernel.BC_KIND)
    assert "moving_lid" not in sharded_mg_kernel.SUPPORTED_BCS
    bnd.define_bc("moving_lid", BC.user, is_solid=False)
    mesh = mesh_comm.make_mesh(device="cpu")
    for use_pallas in (None, True):
        with pytest.raises(ValueError, match="moving_lid"):
            sharded_mg.ShardedMG(16, 16, mesh, yr_BC_type="moving_lid",
                                 use_pallas=use_pallas)


def test_cavity_solve_runs_the_kernel_entries(monkeypatch):
    """A cavity solve on a CUDA tensor goes through mg_core, mg_down and
    mg_up with the ZERO kind and no plain version: with the launches
    stubbed to record their C arguments, a 1024^2 cycle (3 peeled levels
    in float32) calls each entry, every call with the kinds 1, 1, 1, 3."""
    mg = _cavity_mg(1024)
    seen = []

    class Lib:
        def __getattr__(self, name):
            def fn(*args):
                kinds = next(a for a in args
                             if isinstance(a, mg_kernel.ctypes.Array) and
                             a._type_ is mg_kernel.ctypes.c_int and
                             len(a) == 4)
                seen.append((name, list(kinds)))
                return 0
            return fn

        def mg_tile_plan_ints(self):
            return len(mg_kernel.TilePlan.FIELDS)

    monkeypatch.setattr(mg_kernel, "_load", lambda: Lib())
    monkeypatch.setattr(mg_kernel, "_check_tensors", lambda *a: None)
    monkeypatch.setattr(mg_kernel, "_run",
                        lambda fn, device, *args: fn(*args, None))
    for name in ("core_plain", "down_plain", "up_plain"):
        monkeypatch.setattr(mg_kernel, name, None)
    f = torch.zeros((1026, 1026), dtype=torch.float32, device="meta")
    mg_kernel.cycle(mg, None, f)
    names = [n for n, _ in seen]
    assert names.count("mg_down_f32") == names.count("mg_up_f32") == 3
    assert names.count("mg_core_f32") == 1
    assert all(k == [1, 1, 1, mg_kernel.ZERO] for _, k in seen)
