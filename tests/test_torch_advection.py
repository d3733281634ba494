"""Parity of the port's five advection solvers and its WENO reconstruction
with pyro2_tpu, and the four advection goldens.

Both packages get the same seeded numpy inputs on the CPU in float64 (JAX
x64).  Tolerances:
  * _weno_combine, weno_upwind, weno and every flux function: bit for bit
    against the JAX functions called eagerly (each jnp operation on its
    own, as the JAX package's tests call them);
  * each Simulation (advection, advection_rk, advection_fv4 and
    advection_weno at 32^2 on tophat or smooth, advection_nonuniform on
    slotted at 32^2), 5 steps: every cell of the state bit for bit, each
    dt and t equal, against the JAX steps run under jax.disable_jit().
    The jitted JAX steps differ from their own eager operations (XLA
    fuses and contracts them): by an ulp for the CTU and fv4 updates, and
    by up to 2e-12 of max|a| for WENO order 3, whose weights
    C/(1e-16 + beta^2) amplify an ulp where the profile is flat;
  * the goldens (pyro2_tpu/test.py's advection runs): each variable over
    the valid region with numpy.allclose at rtol 1e-12 (numpy's default
    atol, as the JAX package's compare), with the golden's step count and
    time.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro2_tpu.mesh.reconstruction as jrec
import pyro2_tpu.solvers.advection.advective_fluxes as jadv
import pyro2_tpu.solvers.advection_fv4.fluxes as jfv4
import pyro2_tpu.solvers.advection_nonuniform.advective_fluxes as jnon
import pyro2_tpu.solvers.advection_rk.fluxes as jrk
import pyro2_tpu.solvers.advection_weno.fluxes as jweno
from pyro2_tpu import Pyro as JPyro
from pyro2_tpu.mesh.grid import Cartesian2d as JGrid
from pyro2_tpu.solvers.advection_nonuniform.simulation import \
    _shift as jshift
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.mesh import reconstruction as rec
from pyro2_tpu_torch.mesh.grid import Cartesian2d
from pyro2_tpu_torch.pyro_sim import valid_solvers
from pyro2_tpu_torch.solvers.advection import advective_fluxes as adv
from pyro2_tpu_torch.solvers.advection_fv4 import fluxes as fv4
from pyro2_tpu_torch.solvers.advection_nonuniform import \
    advective_fluxes as non
from pyro2_tpu_torch.solvers.advection_nonuniform.simulation import _shift
from pyro2_tpu_torch.solvers.advection_rk import fluxes as rk
from pyro2_tpu_torch.solvers.advection_weno import fluxes as weno

h5py = pytest.importorskip("h5py")

ROOT = Path(__file__).resolve().parents[1]
SOLVERS = ["advection", "advection_nonuniform", "advection_rk",
           "advection_fv4", "advection_weno"]


class _RP:
    """The runtime-parameter lookup the flux functions make."""

    def __init__(self, **params):
        self.params = params

    def get_param(self, key):
        return self.params[key.split(".")[1]]


def _grids(nx=12, ny=9, ng=4):
    return (JGrid(nx, ny, ng=ng, xmax=1.2, ymax=0.9),
            Cartesian2d(nx, ny, ng=ng, xmax=1.2, ymax=0.9))


def _field(g, seed):
    return np.random.default_rng(seed).uniform(-1.0, 2.0, (g.qx, g.qy))


def _same(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    assert np.array_equal(ref, got), np.abs(ref - got).max()


def _pairs(ref, got):
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        _same(r, g)


# -- WENO reconstruction ------------------------------------------------------

@pytest.mark.parametrize("order", [2, 3])
def test_weno_combine_matches_jax(order):
    q = np.random.default_rng(order).uniform(-1, 1, (7, 2 * order + 5))
    q[2] = 0.5      # a flat row: the beta -> 0 branch of the weights
    jq, tq = jnp.asarray(q), torch.as_tensor(q)
    ref = jrec._weno_combine(lambda o: jnp.roll(jq, -o, axis=1), order)
    got = rec._weno_combine(lambda o: torch.roll(tq, -o, dims=1), order)
    _same(ref, got)


@pytest.mark.parametrize("order", [2, 3])
def test_weno_upwind_matches_jax(order):
    rng = np.random.default_rng(10 + order)
    for _ in range(20):
        q = rng.uniform(-1, 1, 2 * order - 1)
        _same(jrec.weno_upwind(q, order), rec.weno_upwind(q, order))


@pytest.mark.parametrize("axis", [0, 1, -1])
@pytest.mark.parametrize("order", [2, 3])
def test_weno_matches_jax(order, axis):
    q = np.random.default_rng(20 + order).uniform(0.5, 2.0, (13, 11))
    _pairs(jrec.weno(q, order, axis=axis),
           rec.weno(torch.as_tensor(q), order, axis=axis))


# -- flux functions -----------------------------------------------------------

@pytest.mark.parametrize("limiter", [0, 1, 2])
@pytest.mark.parametrize("u,v", [(1.0, 0.7), (-1.0, 0.7), (0.6, -1.0),
                                 (-0.4, -1.0)])
def test_ctu_fluxes_match_jax(u, v, limiter):
    jg, g = _grids()
    a = _field(g, 1)
    dt = 0.8 * g.dx / max(abs(u), abs(v))
    _pairs(jadv.unsplit_fluxes(jnp.asarray(a), jg, u, v, limiter, dt),
           adv.unsplit_fluxes(torch.as_tensor(a), g, u, v, limiter, dt))


@pytest.mark.parametrize("limiter", [0, 2])
def test_nonuniform_fluxes_match_jax(limiter):
    """A rotating field: both signs of u and of v, and zeros."""
    jg, g = _grids(16, 16)
    a = _field(g, 2)
    u = 0.5 * (g.y2d - 0.45)
    v = -0.5 * (g.x2d - 0.6)
    u[:, 3] = 0.0
    rp = _RP(limiter=limiter)
    dt = 0.8 * g.dx / np.abs(u).max()
    ref = jnon.unsplit_fluxes(jnp.asarray(a), jnp.asarray(u), jnp.asarray(v),
                              jnp.asarray(jshift(u)), jnp.asarray(jshift(v)),
                              jg, rp, dt)
    tu, tv = torch.as_tensor(u), torch.as_tensor(v)
    _same(jshift(u), _shift(tu))
    got = non.unsplit_fluxes(torch.as_tensor(a), tu, tv, _shift(tu),
                             _shift(tv), g, rp, dt)
    _pairs(ref, got)


@pytest.mark.parametrize("u,v", [(1.0, 0.5), (-1.0, -0.5)])
def test_rk_fluxes_match_jax(u, v):
    jg, g = _grids()
    a = _field(g, 3)
    rp = _RP(u=u, v=v, limiter=2)
    _pairs(jrk.fluxes(jnp.asarray(a), jg, rp),
           rk.fluxes(torch.as_tensor(a), g, rp))


@pytest.mark.parametrize("limiter", [0, 2])
@pytest.mark.parametrize("u,v", [(1.0, 0.5), (-1.0, -0.5)])
def test_fv4_fluxes_match_jax(u, v, limiter):
    jg, g = _grids(16, 12)
    a = _field(g, 4)
    rp = _RP(u=u, v=v, limiter=limiter)
    _pairs(jfv4.fluxes(jnp.asarray(a), jg, rp),
           fv4.fluxes(torch.as_tensor(a), g, rp))


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("u,v", [(1.0, 0.5), (-0.3, 1.0)])
def test_weno_fluxes_match_jax(u, v, order):
    """Every cell of the padded arrays: the masks zero exactly the cells
    a wrapped roll reaches, as JAX's do."""
    jg, g = _grids()
    a = _field(g, 5)
    rp = _RP(u=u, v=v, weno_order=order)
    _pairs(jweno.fluxes(jnp.asarray(a), jg, rp),
           weno.fluxes(torch.as_tensor(a), g, rp))


@pytest.mark.parametrize("order,ng", [(4, 5), (3, 3)])
def test_weno_fluxes_refuse_as_jax(order, ng):
    jg, g = _grids(ng=ng)
    rp = _RP(u=1.0, v=1.0, weno_order=order)
    with pytest.raises(AssertionError):
        jweno.fluxes(jnp.zeros((jg.qx, jg.qy)), jg, rp)
    with pytest.raises(AssertionError):
        weno.fluxes(torch.zeros(g.qx, g.qy, dtype=torch.float64), g, rp)


# -- whole solvers ------------------------------------------------------------

RUNS = [("advection", "tophat", {}),
        ("advection", "smooth", {"advection.u": -1.0, "advection.v": 0.5}),
        ("advection_rk", "smooth", {}),
        ("advection_fv4", "smooth", {}),
        ("advection_fv4", "tophat", {"advection.limiter": 0}),
        ("advection_weno", "smooth", {}),
        ("advection_weno", "tophat", {"advection.weno_order": 2}),
        ("advection_nonuniform", "slotted", {})]


def test_the_advection_solvers_are_pyro_solvers():
    assert [s for s in valid_solvers if s.startswith("advection")] == \
        SOLVERS


@pytest.mark.parametrize("solver,problem,extra", RUNS)
def test_five_steps_match_jax(solver, problem, extra):
    inputs = {"mesh.nx": 32, "mesh.ny": 32, **extra}
    pj = JPyro(solver)
    pj.initialize_problem(problem, inputs_dict=inputs)
    pt = Pyro(solver, device="cpu")
    pt.initialize_problem(problem, inputs_dict=inputs)
    assert pt.sim.cc_data.names == pj.sim.cc_data.names
    _same(pj.sim.cc_data.data, pt.sim.cc_data.data)
    for _ in range(5):
        with jax.disable_jit():
            pj.single_step()
        pt.single_step()
        assert pt.sim.dt == pj.sim.dt
        _same(pj.sim.cc_data.data, pt.sim.cc_data.data)
    assert pt.sim.n == pj.sim.n == 5
    assert pt.sim.cc_data.t == pj.sim.cc_data.t


def test_advection_dt_reads_nothing_from_the_tensors(monkeypatch):
    """The constant-velocity CFL is host arithmetic: no tensor read."""
    p = Pyro("advection", device="cpu")
    p.initialize_problem("smooth", inputs_dict={"mesh.nx": 16,
                                                "mesh.ny": 16})
    monkeypatch.setattr(p.sim.cc_data, "data", None)
    p.sim.method_compute_timestep()
    assert p.sim.dt == 0.8 / 16


GOLDENS = [("advection", "smooth", "smooth_0040.h5", 40),
           ("advection_nonuniform", "slotted", "slotted_0248.h5", 248),
           ("advection_rk", "smooth", "smooth_0081.h5", 81),
           ("advection_fv4", "smooth", "smooth_0081.h5", 81)]


@pytest.mark.parametrize("solver,problem,fname,nsteps", GOLDENS)
def test_matches_golden(solver, problem, fname, nsteps):
    p = Pyro(solver, device="cpu")
    p.initialize_problem(problem, inputs_file=f"inputs.{problem}",
                         inputs_dict={"driver.verbose": 0, "vis.dovis": 0,
                                      "io.do_io": 0})
    p.run_sim()
    g = p.get_grid()
    golden = ROOT / "pyro2_tpu" / "solvers" / solver / "tests" / fname
    with h5py.File(golden, "r") as f:
        assert int(f.attrs["nsteps"]) == p.sim.n == nsteps
        assert float(f.attrs["time"]) == pytest.approx(p.sim.cc_data.t,
                                                       rel=1e-12)
        names = sorted(f["state"])
        assert names == sorted(p.sim.cc_data.names)
        for name in names:
            ref = f["state"][name]["data"][()]
            got = p.get_var(name)[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1].numpy()
            assert np.allclose(got, ref, rtol=1e-12), \
                (name, np.abs(got - ref).max())
