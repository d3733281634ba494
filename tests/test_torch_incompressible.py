"""Parity of the PyTorch port's incompressible (projection) solver, and the
Burgers layers under it, with pyro2_tpu.

The same inputs, made from a numpy seed or by each package's own problem
module, go through the JAX functions (CPU, x64) and the port (CPU,
float64).  Tolerances:
  * interface stages and one Burgers step: 1e-12 max|x| (the same float64
    operations);
  * Pyro runs (preevolve's projection and throw-away step, then steps,
    three multigrid solves each with float64 roundoff at their floor): the
    velocities, phi, phi-MAC and gradp to 1e-10 times each field's max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu.mesh.grid import Grid2d as JGrid2d
from pyro2_tpu.solvers.burgers import burgers_interface as jbi
from pyro2_tpu.solvers.incompressible import incomp_interface as jii
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.multigrid import MG
from pyro2_tpu_torch.solvers.burgers import burgers_interface as tbi
from pyro2_tpu_torch.solvers.burgers.simulation import Simulation as TBurgers
from pyro2_tpu_torch.solvers.incompressible import incomp_interface as tii
from pyro2_tpu_torch.util.carry import carry


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(ref, got, tol):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    err = np.abs(ref - got).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-300), err


def _fields(rng, g, n):
    return [rng.standard_normal((g.qx, g.qy)) for _ in range(n)]


# -- the interface stages -----------------------------------------------------

def test_burgers_interface_matches_jax():
    rng = np.random.default_rng(1)
    jg, tg = JGrid2d(16, 12, ng=4), Grid2d(16, 12, ng=4)
    u, v, lux, lvx, luy, lvy = _fields(rng, tg, 6)
    u[::3] = 0.0                 # zero velocities reach the upwind ties
    dt = 0.01
    js = jbi.get_interface_states(jg, dt, *map(jnp.asarray,
                                               (u, v, lux, lvx, luy, lvy)))
    ts = tbi.get_interface_states(tg, dt, *map(torch.as_tensor,
                                               (u, v, lux, lvx, luy, lvy)))
    for a, b in zip(js, ts):
        _close(a, b, 1e-12)
    js = jbi.apply_transverse_corrections(jg, dt, *js)
    ts = tbi.apply_transverse_corrections(tg, dt, *ts)
    for a, b in zip(js, ts):
        _close(a, b, 1e-12)
    for a, b in zip(jbi.construct_unsplit_fluxes(jg, *js),
                    tbi.construct_unsplit_fluxes(tg, *ts)):
        _close(a, b, 1e-12)


def test_incomp_interface_matches_jax():
    rng = np.random.default_rng(2)
    jg, tg = JGrid2d(12, 16, ng=4), Grid2d(12, 16, ng=4)
    ins = _fields(rng, tg, 8)
    ins[0][:, ::4] = 0.0
    dt = 0.02
    src = _fields(rng, tg, 2)
    ju, jv = jii.mac_vels(jg, dt, *map(jnp.asarray, ins),
                          *map(jnp.asarray, src))
    tu, tv = tii.mac_vels(tg, dt, *map(torch.as_tensor, ins),
                          *map(torch.as_tensor, src))
    _close(ju, tu, 1e-12)
    _close(jv, tv, 1e-12)
    js = jii.states(jg, dt, *map(jnp.asarray, ins), ju, jv)
    ts = tii.states(tg, dt, *map(torch.as_tensor, ins), tu, tv)
    for a, b in zip(js, ts):
        _close(a, b, 1e-12)


def test_burgers_step_matches_jax():
    pj = JPyro("burgers")
    pj.initialize_problem("tophat", inputs_dict={"mesh.nx": 24,
                                                 "mesh.ny": 24})
    jsim = pj.sim
    rp, U = carry(jsim.rp.params, np.asarray(jsim.cc_data.data),
                  device="cpu")
    tsim = TBurgers("burgers", "tophat", lambda d, rp: None, rp,
                    device="cpu")
    tsim.initialize()
    tsim.cc_data.set_vars(U)
    tsim.cc_data.t = jsim.cc_data.t = 0.0
    for sim in (jsim, tsim):
        sim.compute_timestep()
        sim.evolve()
    assert tsim.dt == jsim.dt
    _close(jsim.cc_data.data, tsim.cc_data.data, 1e-12)


# -- Pyro runs ----------------------------------------------------------------

def _run_pair(problem, inputs, steps):
    pj = JPyro("incompressible")
    pj.initialize_problem(problem, inputs_dict=inputs)
    pt = Pyro("incompressible", device="cpu")
    pt.initialize_problem(problem, inputs_dict=inputs)
    for _ in range(steps):
        pj.single_step()
        pt.single_step()
    return pj, pt


def _assert_state_matches(pj, pt, tol=1e-10):
    a = np.asarray(pj.sim.cc_data.data)
    b = pt.sim.cc_data.data.numpy()
    assert pt.sim.cc_data.names == pj.sim.cc_data.names
    for n, name in enumerate(pt.sim.cc_data.names):
        scale = np.abs(a[n]).max()
        assert np.abs(a[n] - b[n]).max() <= tol * scale, name


@pytest.mark.parametrize("problem,steps", [("shear", 3), ("converge", 3)])
def test_run_matches_jax(problem, steps):
    pj, pt = _run_pair(problem, {"mesh.nx": 32, "mesh.ny": 32}, steps)
    assert pt.sim.n == steps and pt.sim.dt == pj.sim.dt
    assert pt.sim.cc_data.t == pj.sim.cc_data.t
    _assert_state_matches(pj, pt)


def test_preevolve_restores_the_projected_state():
    """preevolve projects, takes a throw-away step, and restores the
    projected state with the new gradp: the restored state must be the
    JAX package's, with time and step count untouched."""
    pj, pt = _run_pair("shear", {"mesh.nx": 32, "mesh.ny": 32}, 0)
    assert pt.sim.n == 0 and pt.sim.cc_data.t == 0.0
    _assert_state_matches(pj, pt)
    assert float(pt.sim.cc_data.get_var("gradp_x").abs().max()) > 0.0


def test_preevolve_needs_a_clone_that_copies(monkeypatch):
    """With a clone that shares the state tensor (as the JAX clone may,
    its arrays being immutable), the throw-away step would leak into the
    restored state."""
    copying_clone = patch.cell_center_data_clone

    def sharing_clone(old):
        new = copying_clone(old)
        new.data = old.data
        return new

    pt = Pyro("incompressible", device="cpu")
    monkeypatch.setattr(patch, "cell_center_data_clone", sharing_clone)
    pt.initialize_problem("shear", inputs_dict={"mesh.nx": 16,
                                                "mesh.ny": 16})
    leaked = pt.sim.cc_data.get_var("x-velocity").clone()
    monkeypatch.undo()
    pt2 = Pyro("incompressible", device="cpu")
    pt2.initialize_problem("shear", inputs_dict={"mesh.nx": 16,
                                                 "mesh.ny": 16})
    assert not torch.equal(leaked, pt2.sim.cc_data.get_var("x-velocity"))


def test_three_solves_per_step():
    pt = Pyro("incompressible", device="cpu")
    before = dict(MG.stats)
    pt.initialize_problem("converge", inputs_file="inputs.converge.32")
    assert MG.stats["solves"] == before["solves"] + 3   # preevolve
    pt.single_step()
    assert MG.stats["solves"] == before["solves"] + 5


def test_walls_use_neumann_projections():
    pt = Pyro("incompressible", device="cpu")
    inputs = {"mesh.nx": 16, "mesh.ny": 16}
    for edge in ("xl", "xr", "yl", "yr"):
        inputs[f"mesh.{edge}boundary"] = "reflect"
    pt.initialize_problem("converge", inputs_file="inputs.converge.32",
                          inputs_dict=inputs)
    assert pt.sim.cc_data.BCs["phi"].xlb == "neumann"
    pt.single_step()
    assert bool(torch.isfinite(pt.sim.cc_data.data).all())


def test_particles_are_not_ported_yet():
    """Particles are ported (the name is the test's from before): grid
    particles on shear 16x16 for 4 steps against a JAX Particles advanced
    with the JAX solver's projected velocities after each step -- the JAX
    incompressible evolve asks for a derived "velocity" its data lacks --
    at rtol 1e-12, `active` equal; none moves in the pre-evolution."""
    from pyro2_tpu.particles.particles import Particles as JParticles
    from pyro2_tpu.simulation_null import bc_setup

    inputs = {"mesh.nx": 16, "mesh.ny": 16,
              "particles.particle_generator": "grid",
              "particles.n_particles": 36}
    pt = Pyro("incompressible", device="cpu")
    pt.initialize_problem("shear", inputs_dict={
        **inputs, "particles.do_particles": 1})
    tp = pt.sim.particles
    assert np.array_equal(tp.positions.numpy(), tp.init_positions.numpy())
    pj = JPyro("incompressible")
    pj.initialize_problem("shear", inputs_dict=inputs)
    jp = JParticles(pj.sim.cc_data, bc_setup(pj.rp)[0], 36, "grid")
    for _ in range(4):
        pt.single_step()
        pj.single_step()
        jp.update_particles(pj.sim.dt, pj.sim.cc_data.get_var("x-velocity"),
                            pj.sim.cc_data.get_var("y-velocity"))
        np.testing.assert_allclose(tp.positions.numpy(),
                                   np.asarray(jp.positions), rtol=1e-12)
        assert np.array_equal(tp.active.numpy(), np.asarray(jp.active))
    assert not np.array_equal(tp.positions.numpy(),
                              tp.init_positions.numpy())
