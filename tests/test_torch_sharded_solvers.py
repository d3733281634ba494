"""Parity of the port's sharded MOL and multigrid tiers (pyro2_tpu_torch/
parallel/sharded_mol.py, sharded_incompressible.py,
sharded_burgers_viscous.py) with the port's serial solvers and with
pyro2_tpu.

Every case runs on gloo ranks of a 2x2 and a 1x4 mesh (one launch each,
all cases in it: torch_rank_programs.sharded_solvers) and on the 1x1 mesh
in this process, in float64, each from its blockwise initial state.

Tolerances:
* the MOL classes against the port's serial runs: bits on every mesh
  (the stage loop is the serial integrator's arithmetic on the same
  values; the rk stage takes the block's domain-edge flags);
* rk and fv4 against the JAX package's serial solvers, and the advect
  cases against its sharded classes on a 2x2 mesh of conftest's fake CPU
  devices: 1e-12 of max|U| (XLA fuses the jitted stages and may contract
  a multiply and an add where torch rounds each);
* the multigrid classes against the port's serial runs and JAX's sharded
  classes: 1e-11 of max(1, |ref|) for the incompressible solver (JAX's
  TestShardedIncompressible), rtol 1e-11 and atol 1e-12 for the viscous
  ones (JAX's TestShardedIncompressibleViscous and
  TestShardedBurgersViscous): the solves sum their norms over the ranks,
  which may round apart from the serial sums.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import torch_rank_programs as trp

from pyro2_tpu.parallel import make_mesh as jmake_mesh
from pyro2_tpu.util.runparams import RuntimeParameters as JRP
from pyro2_tpu_torch import parallel
from pyro2_tpu_torch.parallel import launch, make_mesh
from pyro2_tpu_torch.util.runparams import RuntimeParameters

SOLVER = {"ShardedCompressibleRK": "compressible_rk",
          "ShardedCompressibleFV4": "compressible_fv4",
          "ShardedCompressibleSDC": "compressible_sdc",
          "ShardedIncompressible": "incompressible",
          "ShardedIncompressibleViscous": "incompressible_viscous",
          "ShardedBurgersViscous": "burgers_viscous"}
MOL = ("ShardedCompressibleRK", "ShardedCompressibleFV4",
       "ShardedCompressibleSDC")


def _bcs(kind):
    return {f"mesh.{e}boundary": kind for e in ("xl", "xr", "yl", "yr")}


PERIODIC = _bcs("periodic")
QUAD = {**_bcs("outflow"), "compressible.cvisc": 0.1}


def _case(cls, problem, n, overrides, steps, dt, *, pre=False, jax=None):
    """jax: None, "serial" (the JAX serial solver with the port's dts) or
    "sharded" (the JAX sharded class on a 2x2 mesh)."""
    return {"cls": cls, "problem": problem, "steps": steps, "dt": dt,
            "pre": pre, "jax": jax,
            "overrides": {"mesh.nx": n, "mesh.ny": n, **overrides}}


CASES = {
    "rk_advect": _case("ShardedCompressibleRK", "advect", 32, PERIODIC, 2,
                       0.002, jax="sharded"),
    # shocks across the seams of both meshes, and the CFL dt (pmin)
    "rk_quad": _case("ShardedCompressibleRK", "quad", 32, QUAD, 2, None,
                     jax="serial"),
    # a density floor above quad's low quadrant, which the seams cross:
    # each stage floors the seam halos as the serial grid floors them
    "rk_quad_floor": _case("ShardedCompressibleRK", "quad", 32,
                           {**QUAD, "compressible.small_dens": 0.2}, 2,
                           None),
    "fv4_advect": _case("ShardedCompressibleFV4", "advect", 32, PERIODIC, 2,
                        0.002, pre=True, jax="sharded"),
    "fv4_quad": _case("ShardedCompressibleFV4", "quad", 32, QUAD, 2, None,
                      pre=True, jax="serial"),
    "sdc_advect": _case("ShardedCompressibleSDC", "advect", 16, PERIODIC, 1,
                        0.002, pre=True, jax="sharded"),
    # the CFL dt through pmax, the three inline solves of a step
    "incompressible": _case("ShardedIncompressible", "shear", 32, PERIODIC,
                            2, None, pre=True, jax="sharded"),
    "viscous": _case("ShardedIncompressibleViscous", "shear", 16,
                     {**PERIODIC, "incompressible_viscous.viscosity": 0.005},
                     2, None, pre=True, jax="sharded"),
    "burgers_viscous": _case("ShardedBurgersViscous", "tophat", 16,
                             {**PERIODIC, "diffusion.eps": 0.005}, 2, None,
                             jax="sharded"),
}
NAMES = list(CASES)


def _params(pkg, case):
    """The runtime parameters of a case in a package's RuntimeParameters
    class: the package's defaults, the solver's and the problem's, then
    the overrides."""
    solver = SOLVER[case["cls"]]
    rp = (RuntimeParameters if pkg == "pyro2_tpu_torch" else JRP)()
    rp.load_params(f"{pkg}/_defaults")
    rp.load_params(f"{pkg}/solvers/{solver}/_defaults")
    problem = importlib.import_module(
        f"{pkg}.solvers.{solver}.problems.{case['problem']}")
    for k, v in {**getattr(problem, "PROBLEM_PARAMS", {}),
                 "driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0,
                 **case["overrides"]}.items():
        rp.set_param(k, v, no_new=False)
    return rp


def _simulation(pkg, case):
    solver = SOLVER[case["cls"]]
    mod = importlib.import_module(f"{pkg}.solvers.{solver}")
    pmod = importlib.import_module(
        f"{pkg}.solvers.{solver}.problems.{case['problem']}")
    kw = {"device": "cpu"} if pkg == "pyro2_tpu_torch" else {}
    sim = mod.Simulation(solver, case["problem"], pmod.init_data,
                         _params(pkg, case), **kw)
    sim.initialize()
    return sim


def _interior(sim):
    g = sim.cc_data.grid
    return np.array(sim.cc_data.data[:, g.ilo:g.ihi + 1, g.jlo:g.jhi + 1])


def _run_serial(sim, case, dts=None):
    """Step a serial Simulation as the driver does (fill, dt, evolve),
    after its preevolve where the case has one; `dts` fixes the steps'
    dts.  Returns the dts taken."""
    if case["pre"]:
        sim.cc_data.fill_BC_all()
        sim.preevolve()
    taken = []
    for n in range(case["steps"]):
        sim.cc_data.fill_BC_all()
        if dts is not None:
            sim.dt = dts[n]
        elif case["dt"] is None:
            sim.method_compute_timestep()
        else:
            sim.dt = case["dt"]
        taken.append(sim.dt)
        sim.evolve()
    return taken


@functools.lru_cache(maxsize=None)
def _serial(name):
    """The port's serial run of a case: (initial interior, final interior,
    dts)."""
    case = CASES[name]
    sim = _simulation("pyro2_tpu_torch", case)
    U0 = _interior(sim)
    dts = _run_serial(sim, case)
    return U0, _interior(sim), dts


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX package's run of a case: its serial solver with the port's
    dts, or its sharded class on a 2x2 mesh."""
    case = CASES[name]
    if case["jax"] == "serial":
        sim = _simulation("pyro2_tpu", case)
        _run_serial(sim, case, dts=_serial(name)[2])
        return _interior(sim)
    module = importlib.import_module(
        "pyro2_tpu.parallel." + ("sharded_mol" if case["cls"] in MOL else
                                 "sharded_" + SOLVER[case["cls"]].replace(
                                     "_viscous", "")
                                 if case["cls"] != "ShardedBurgersViscous"
                                 else "sharded_burgers_viscous"))
    sh = getattr(module, case["cls"])(_params("pyro2_tpu", case),
                                      jmake_mesh(shape=(2, 2)),
                                      problem=case["problem"])
    if case["cls"] in MOL:
        U = sh.init_interior()
        if case["pre"]:
            U = sh.preevolve_interior(U)
        t = 0.0
        for _ in range(case["steps"]):
            U = sh.step(U, t, case["dt"])
            t += case["dt"]
        return np.asarray(U)
    if case["pre"]:
        sh.preevolve()
    for _ in range(case["steps"]):
        sh.method_compute_timestep()
        sh.evolve()
    return np.asarray(sh.U_int)


def _rank_cases():
    return [{**c, "params": _params("pyro2_tpu_torch", c).params}
            for c in CASES.values()]


@pytest.fixture(scope="module")
def runs():
    """{mesh shape: {case: result}} of the port on gloo ranks (2x2, 1x4)
    and in this process (1x1), every rank's gathered result checked equal
    to rank 0's."""
    cases = _rank_cases()
    out = {(1, 1): dict(zip(NAMES, launch.to_host(trp.sharded_solvers(
        make_mesh(device="cpu"), cases))))}
    for shape in ((2, 2), (1, 4)):
        ranks = launch.run(trp.sharded_solvers, shape, cases, device="cpu",
                           timeout=600)
        for res in ranks[1:]:
            for a, b in zip(ranks[0], res):
                np.testing.assert_array_equal(a["U"], b["U"])
                assert a["dts"] == b["dts"]
        out[shape] = dict(zip(NAMES, ranks[0]))
    return out


def _close(got, ref, name):
    """The multigrid tier's tolerance against a reference run."""
    if CASES[name]["cls"] == "ShardedIncompressible":
        scale = max(1.0, np.abs(ref).max())
        assert np.abs(got - ref).max() < 1e-11 * scale
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-12)


def _check(runs, name):
    U0, U, dts = _serial(name)
    assert np.isfinite(U).all() and not np.array_equal(U, U0)
    mol = CASES[name]["cls"] in MOL
    for shape in ((1, 1), (2, 2), (1, 4)):
        res = runs[shape][name]
        np.testing.assert_array_equal(res["U0"], U0, err_msg=str(shape))
        if mol:
            np.testing.assert_array_equal(res["U"], U, err_msg=str(shape))
            assert res["dts"] == dts, shape
        else:
            _close(res["U"], U, name)
            np.testing.assert_allclose(res["dts"], dts, rtol=1e-12)
    if CASES[name]["jax"] is None:
        return
    ref = _jax(name)
    if mol:
        assert np.abs(ref - U).max() <= 1e-12 * np.abs(U).max()
    else:
        _close(runs[(2, 2)][name]["U"], ref, name)


class TestShardedMOL:
    """The stage loops equal the serial evolve by bits on every mesh."""

    @pytest.mark.parametrize("name", ["rk_advect", "rk_quad"])
    def test_rk(self, runs, name):
        _check(runs, name)

    def test_rk_density_floor_on_seam_halos(self, runs):
        _check(runs, "rk_quad_floor")
        assert _serial("rk_quad_floor")[0][0].min() < 0.2

    @pytest.mark.parametrize("name", ["fv4_advect", "fv4_quad"])
    def test_fv4_preevolve_and_steps(self, runs, name):
        _check(runs, name)

    def test_sdc(self, runs):
        _check(runs, "sdc_advect")

    def test_fv4_preevolve_alone(self):
        """preevolve_interior is the serial preevolve's conversion."""
        case = CASES["fv4_quad"]
        sim = _simulation("pyro2_tpu_torch", case)
        sh = parallel.ShardedCompressibleFV4(
            _params("pyro2_tpu_torch", case), make_mesh(device="cpu"),
            problem="quad", dtype=torch.float64)
        U = sh.preevolve_interior(sh.init_interior())
        sim.cc_data.fill_BC_all()
        sim.preevolve()
        np.testing.assert_array_equal(U.numpy(), _interior(sim))


class TestShardedMultigridSolvers:
    """Three inline solves a step (the viscous solver five), to roundoff
    of the serial solvers and of JAX's sharded classes."""

    @pytest.mark.parametrize("name", ["incompressible", "viscous",
                                      "burgers_viscous"])
    def test_matches_serial_and_jax(self, runs, name):
        _check(runs, name)

    def test_one_rank_is_the_serial_run(self, runs):
        """On the 1x1 mesh the norms sum one block: the serial bits."""
        for name in ("incompressible", "viscous", "burgers_viscous"):
            _, U, dts = _serial(name)
            np.testing.assert_array_equal(runs[(1, 1)][name]["U"], U)
            assert runs[(1, 1)][name]["dts"] == dts


class TestShardedDtAndRefusals:
    def test_cfl_dt_equals_serial_dt(self):
        """pmin (MOL) and pmax (multigrid tiers) give the serial dt."""
        mesh = make_mesh(device="cpu")
        case = CASES["rk_quad"]
        sh = parallel.ShardedCompressibleRK(
            _params("pyro2_tpu_torch", case), mesh, problem="quad",
            dtype=torch.float64)
        sim = _simulation("pyro2_tpu_torch", case)
        sim.cc_data.fill_BC_all()
        sim.method_compute_timestep()
        assert sh.compute_dt(sh.init_interior()) == sim.dt
        for name in ("incompressible", "burgers_viscous"):
            case = CASES[name]
            sh = getattr(parallel, case["cls"])(
                _params("pyro2_tpu_torch", case), mesh,
                problem=case["problem"], dtype=torch.float64)
            sim = _simulation("pyro2_tpu_torch", case)
            sim.cc_data.fill_BC_all()
            sim.method_compute_timestep()
            sh.method_compute_timestep()
            assert sh.dt == sim.dt

    @pytest.mark.parametrize("name", NAMES)
    def test_grid_must_divide(self, name):
        rp = _params("pyro2_tpu_torch", CASES[name])
        rp.set_param("mesh.nx", 30, no_new=False)
        from pyro2_tpu_torch.parallel.mesh_comm import Mesh
        with pytest.raises(ValueError, match="divide"):
            getattr(parallel, CASES[name]["cls"])(
                rp, Mesh((4, 1), "cpu", (0, 0)),
                problem=CASES[name]["problem"])

    def test_moving_lid_refused(self):
        case = _case("ShardedIncompressibleViscous", "cavity", 16,
                     {**_bcs("dirichlet"), "mesh.yrboundary": "moving_lid"},
                     1, None)
        with pytest.raises(ValueError, match="moving_lid"):
            parallel.ShardedIncompressibleViscous(
                _params("pyro2_tpu_torch", case), make_mesh(device="cpu"),
                problem="cavity")

    @pytest.mark.parametrize("name", ["rk_advect", "incompressible",
                                      "burgers_viscous"])
    def test_unknown_bc_refused(self, name):
        rp = _params("pyro2_tpu_torch", CASES[name])
        rp.set_param("mesh.xlboundary", "no-such-bc", no_new=False)
        with pytest.raises((ValueError, KeyError)):
            getattr(parallel, CASES[name]["cls"])(
                rp, make_mesh(device="cpu"), problem=CASES[name]["problem"])

    def test_mol_particles_refused(self):
        sh = parallel.ShardedCompressibleRK(
            _params("pyro2_tpu_torch", CASES["rk_advect"]),
            make_mesh(device="cpu"), problem="advect")
        with pytest.raises(TypeError, match="particles"):
            sh.build_step_with_particles(None)
