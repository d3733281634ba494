"""Parity of the port's viscous Burgers solver, Pyro("burgers_viscous"),
with pyro2_tpu.

The same inputs, made from a numpy seed or by each package's problem
module, go through the JAX functions (CPU, x64) and the port (CPU,
float64).  Tolerances:
  * get_lap and apply_diffusion_corrections: 1e-12 max|x| (the same
    float64 operations, which agree bit for bit);
  * diffuse, one Crank-Nicolson multigrid solve: equal cycle counts and
    the solution to 1e-12 max|a| (XLA multiplies by the smoother's
    reciprocal denominator where the port divides: a rounding a sweep);
  * 5 steps of tophat and test through Pyro: equal cycle counts in every
    solve, the state to 1e-12 max|U|, each dt and t to 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu.mesh import boundary as jbnd
from pyro2_tpu.mesh import patch as jpatch
from pyro2_tpu.mesh.grid import Grid2d as JGrid2d
from pyro2_tpu.multigrid import MG as JMG
from pyro2_tpu.solvers.burgers_viscous import interface as jint
from pyro2_tpu.util.runparams import RuntimeParameters as JRP
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.mesh import boundary as tbnd
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.multigrid import MG
from pyro2_tpu_torch.pyro_sim import valid_solvers
from pyro2_tpu_torch.solvers.burgers_viscous import interface as tint
from pyro2_tpu_torch.util.carry import carry_simulation
from pyro2_tpu_torch.util.runparams import RuntimeParameters


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(ref, got, tol):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    err = np.abs(ref - got).max()
    assert err <= tol * np.abs(ref).max(), err


@pytest.fixture
def cycles(monkeypatch):
    """Each package's CellCenterMG2d solves append their cycle counts."""
    counts = {"jax": [], "torch": []}
    for key, cls in (("jax", JMG.CellCenterMG2d),
                     ("torch", MG.CellCenterMG2d)):
        orig = cls.solve

        def solve(self, rtol=1.e-11, _orig=orig, _key=key):
            _orig(self, rtol)
            counts[_key].append(self.num_cycles)

        monkeypatch.setattr(cls, "solve", solve)
    return counts


def test_burgers_viscous_is_a_pyro_solver():
    assert "burgers_viscous" in valid_solvers
    p = Pyro("burgers_viscous", device="cpu")
    p.initialize_problem("tophat", inputs_dict={"mesh.nx": 8,
                                                "mesh.ny": 8})
    assert p.sim._step is None       # evolve steps, with its solves
    assert p.rp.get_param("diffusion.eps") == 0.005


def test_get_lap_matches_jax():
    rng = np.random.default_rng(1)
    jg, tg = JGrid2d(16, 12, ng=4), Grid2d(16, 12, ng=4)
    a = rng.standard_normal((tg.qx, tg.qy))
    _close(jint.get_lap(jg, jnp.asarray(a)),
           tint.get_lap(tg, torch.as_tensor(a)), 1e-12)


def test_apply_diffusion_corrections_matches_jax():
    rng = np.random.default_rng(2)
    jg, tg = JGrid2d(12, 16, ng=4), Grid2d(12, 16, ng=4)
    ins = [rng.standard_normal((tg.qx, tg.qy)) for _ in range(10)]
    tins = [torch.as_tensor(a) for a in ins]
    keep = [t.clone() for t in tins]
    js = jint.apply_diffusion_corrections(jg, 0.013, 0.02,
                                          *map(jnp.asarray, ins))
    ts = tint.apply_diffusion_corrections(tg, 0.013, 0.02, *tins)
    for a, b in zip(js, ts):
        _close(a, b, 1e-12)
    for a, b in zip(keep, tins):            # the inputs are not written
        assert torch.equal(a, b)


@pytest.mark.parametrize("edges", ["periodic", "outflow"])
def test_diffuse_matches_jax(edges, cycles):
    n = 32
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n + 8, n + 8))
    A = rng.standard_normal((n + 8, n + 8))
    params = {"diffusion.eps": 0.005}
    dt = 0.8 / n
    out = []
    for grid, bnd_, pat, rp_cls, mk, lib in (
            (JGrid2d, jbnd, jpatch, JRP, jnp.asarray, jint),
            (Grid2d, tbnd, patch, RuntimeParameters, torch.as_tensor,
             tint)):
        g = grid(n, n, ng=4)
        kw = {} if lib is jint else {"device": "cpu"}
        d = pat.CellCenterData2d(g, **kw)
        d.register_var("x-velocity", bnd_.BC(xlb=edges, xrb=edges,
                                             ylb=edges, yrb=edges))
        d.create()
        d.set_var("x-velocity", mk(a))
        rp = rp_cls()
        rp.params = dict(params)
        before = _np(d.data).copy()
        out.append(lib.diffuse(d, rp, dt, "x-velocity", mk(A)))
        assert np.array_equal(_np(d.data), before)  # the state unwritten
    _close(*out, 1e-12)
    assert cycles["jax"] == cycles["torch"] and len(cycles["torch"]) == 1


@pytest.mark.parametrize("problem", ["tophat", "test"])
def test_steps_match_jax(problem, cycles):
    inputs = {"mesh.nx": 32, "mesh.ny": 32}
    pj = JPyro("burgers_viscous")
    pj.initialize_problem(problem, inputs_dict=inputs)
    pt = Pyro("burgers_viscous", device="cpu")
    pt.initialize_problem(problem, inputs_dict=inputs)
    assert np.array_equal(np.asarray(pj.sim.cc_data.data),
                          pt.sim.cc_data.data.numpy())
    for _ in range(5):
        pj.single_step()
        pt.single_step()
        assert pt.sim.dt == pytest.approx(pj.sim.dt, rel=1e-12)
    assert pt.sim.n == pj.sim.n == 5
    assert pt.sim.cc_data.t == pytest.approx(pj.sim.cc_data.t, rel=1e-12)
    assert cycles["jax"] == cycles["torch"]
    assert len(cycles["torch"]) == 10        # two solves a step
    _close(pj.sim.cc_data.data, pt.sim.cc_data.data, 1e-12)


def test_a_carried_mid_run_state_steps_as_jax_does(cycles):
    pj = JPyro("burgers_viscous")
    pj.initialize_problem("tophat", inputs_dict={"mesh.nx": 32,
                                                 "mesh.ny": 32})
    for _ in range(3):
        pj.single_step()
    jsim = pj.sim
    sim = carry_simulation("burgers_viscous", "tophat", jsim.rp.params,
                           np.asarray(jsim.cc_data.data), t=jsim.cc_data.t,
                           n=jsim.n, device="cpu")
    sim.dt_old = jsim.dt_old        # the time loop's history, not state
    done = len(cycles["jax"])
    for s in (jsim, sim):
        s.cc_data.fill_BC_all()
        s.compute_timestep()
        s.evolve()
    assert sim.dt == pytest.approx(jsim.dt, rel=1e-12)
    assert cycles["jax"][done:] == cycles["torch"]
    _close(jsim.cc_data.data, sim.cc_data.data, 1e-12)
