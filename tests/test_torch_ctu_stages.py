"""Parity of the port's stage-truncated periodic CTU step
(solvers/compressible/padded_step.py: make_ctu_step_padded(..., stages=s),
plain_stages) with pyro2_tpu's make_pallas_ctu_step_padded(..., stages=s)
(pyro2_tpu/solvers/compressible/pallas_step.py:375, body _local_step_fn
:40), which cuts the fused pipeline short after the interface states (1),
the transverse corrections (2) or the final Riemann pair (3).

Cases: advect with the defaults (HLLC) and kh with compressible.riemann =
CGF, at 32^2 on doubly periodic frames.  Tolerances:
  * float32 against the JAX Pallas kernel in interpret mode (tile_rows=8,
    as tests/test_torch_padded.py builds it at 32^2): max|diff| <= 1e-5
    max|out| on the interior (float32 rounding through the prefix);
  * float64 against the JAX jnp composition of the same stages
    (unsplit_fluxes.interface_states, apply_transverse_flux with every
    solid flag 0, riemann.riemann_flux in x and y, summed in
    _local_step_fn's order): max|diff| <= 1e-12 max|out| per variable;
  * every ghost of the output equal to the input's, bit for bit;
  * stages=4 equal to the padded step, bit for bit.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu.solvers.compressible import pallas_step
from pyro2_tpu.solvers.compressible import riemann as jriemann
from pyro2_tpu.solvers.compressible import unsplit_fluxes as jflx
from pyro2_tpu.util import profile_pyro as jprofile
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.solvers.compressible import ctu_kernel, padded_step

PERIODIC = {"mesh.xlboundary": "periodic", "mesh.xrboundary": "periodic",
            "mesh.ylboundary": "periodic", "mesh.yrboundary": "periodic",
            "driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0}
NG = 4
N = 32
CASES = {"advect": ("advect", {}),
         "kh_cgf": ("kh", {"compressible.riemann": "CGF"})}


@functools.lru_cache(maxsize=None)
def _case(case):
    """(JAX Simulation with its ghosts filled, its initial state as numpy,
    the CFL dt)."""
    problem, extra = CASES[case]
    p = JPyro("compressible")
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": N, "mesh.ny": N, **PERIODIC,
        "compressible.small_dens": -1.e30, **extra})
    sim = p.sim
    sim.cc_data.fill_BC_all()
    U0 = sim.cc_data.data
    dt = 0.8 * float(sim._make_dt()(U0))
    return sim, np.array(U0), dt


def _args(sim):
    g = sim.cc_data.grid
    return (g.nx, g.ny, g.dx, g.dy, sim.rp.get_param("eos.gamma"),
            dict(sim.rp.params), sim.ivars)


def _interior(U):
    U = U.numpy() if isinstance(U, torch.Tensor) else np.asarray(U)
    return U[..., NG:-NG, NG:-NG]


def _jnp_stages(sim, U, dt, stages):
    """The JAX jnp composition of the first `stages` stages, summed as
    _local_step_fn sums them."""
    tc = jprofile.TimerCollection()
    rp, ivars = sim.rp, sim.ivars
    U_xl, U_xr, U_yl, U_yr = jflx.interface_states(U, sim.cc_data, rp,
                                                   ivars, tc, dt)
    if stages == 1:
        return U_xl + U_xr + U_yl + U_yr
    solid = types.SimpleNamespace(xl=0, xr=0, yl=0, yr=0)
    U_xl, U_xr, U_yl, U_yr = jflx.apply_transverse_flux(
        U_xl, U_xr, U_yl, U_yr, sim.cc_data, rp, ivars, solid, tc, dt)
    if stages == 2:
        return U_xl + U_xr + U_yl + U_yr
    F_x = jriemann.riemann_flux(1, U_xl, U_xr, sim.cc_data, rp, ivars, 0, 0,
                                tc)
    F_y = jriemann.riemann_flux(2, U_yl, U_yr, sim.cc_data, rp, ivars, 0, 0,
                                tc)
    return F_x + F_y


def _port_stage(sim, U0, dt, stages, dtype):
    """(the filled input frame, the port's stage-`stages` output) on the
    CPU."""
    to_p, from_p, fill, step = padded_step.make_ctu_step_padded(
        *_args(sim), stages=stages)
    P = fill(to_p(torch.as_tensor(U0, dtype=dtype)))
    out = from_p(step(P, dt))
    assert out.dtype == dtype and out.shape == P.shape
    return P, out


def _ghosts_kept(P, out):
    ghost = torch.ones(P.shape[-2:], dtype=torch.bool)
    ghost[NG:-NG, NG:-NG] = False
    return torch.equal(out[..., ghost], P[..., ghost])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("stages", [1, 2, 3])
def test_stage_matches_pallas_interpret(stages, case):
    sim, U0, dt = _case(case)
    to_j, from_j, fill_j, step_j = pallas_step.make_pallas_ctu_step_padded(
        *_args(sim), tile_rows=8, interpret=True, stages=stages)
    dt32 = np.float32(dt)
    ref = _interior(from_j(step_j(fill_j(to_j(U0)), dt32)))

    P, out = _port_stage(sim, U0, float(dt32), stages, torch.float32)
    got = _interior(out)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert _ghosts_kept(P, out)
    # a prefix's sum, not a state one step on
    assert not np.allclose(got, _interior(U0), rtol=1e-2)
    assert padded_step.launches[f"ctu_periodic_s{stages}"] == 0  # CPU


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("stages", [1, 2, 3])
def test_stage_matches_jnp_composition_f64(stages, case):
    sim, U0, dt = _case(case)
    ref = _interior(jax.jit(functools.partial(_jnp_stages, sim, dt=dt,
                                              stages=stages))(U0))
    assert ref.dtype == np.float64

    P, out = _port_stage(sim, U0, dt, stages, torch.float64)
    got = _interior(out)
    for n in range(sim.ivars.nvar):
        scale = np.abs(ref[n]).max()
        assert scale > 0
        assert np.abs(got[n] - ref[n]).max() <= 1e-12 * scale, n
    assert _ghosts_kept(P, out)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stage4_is_the_padded_step(dtype):
    sim, U0, dt = _case("kh_cgf")
    to_p, _, fill, whole = padded_step.make_ctu_step_padded(*_args(sim))
    _, _, _, four = padded_step.make_ctu_step_padded(*_args(sim), stages=4)
    P = fill(to_p(torch.as_tensor(U0, dtype=dtype)))
    assert torch.equal(four(P, dt), whole(P, dt))
    assert four.name == whole.name == "ctu_periodic" and four.stages == 4


@pytest.mark.parametrize("stages", [0, 5])
def test_stages_outside_1_to_4_raise(stages):
    """The JAX entry runs its whole step for such a value (ROADMAP.md
    C.4); the port refuses it."""
    sim, _, _ = _case("advect")
    with pytest.raises(ValueError, match=f"not {stages}"):
        padded_step.make_ctu_step_padded(*_args(sim), stages=stages)


def _react_frame():
    """compressible_react's six-variable state (its two species after the
    four conserved variables) on a doubly periodic 16^2 grid."""
    p = Pyro("compressible_react", device="cpu")
    p.initialize_problem("flame", inputs_dict={
        "mesh.nx": 16, "mesh.ny": 16, **PERIODIC})
    sim = p.sim
    g = sim.cc_data.grid
    args = (g.nx, g.ny, g.dx, g.dy, sim.rp.get_param("eos.gamma"),
            dict(sim.rp.params), sim.ivars)
    return args, sim.cc_data.data


def test_stage_entry_covers_four_variables():
    """On CUDA the stage entries take the compressible solver's 4
    variables and refuse others naming ROADMAP.md A.32, before any
    kernel is built; on the CPU such a frame runs the plain prefix."""
    padded_step.stages_covered(4, 2)
    padded_step.stages_covered(6, 4)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.32"):
        padded_step.stages_covered(6, 2)

    args, U0 = _react_frame()
    assert args[-1].nvar == 6
    to_p, _, fill, step = padded_step.make_ctu_step_padded(*args, stages=2)
    P = fill(to_p(U0))
    with pytest.raises(NotImplementedError, match="4 variables, not 6"):
        step.launch(P, 1e-4)
    out = step(P, 1e-4)
    assert bool(torch.isfinite(out).all()) and _ghosts_kept(P, out)
    assert padded_step.launches["ctu_periodic_s2"] == 0


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
def test_stage_work_counts_the_prefix(stages):
    """A prefix's bound moves the whole step's bytes and does its own
    operations, fewer than the next stage's."""
    nbytes, nops = ctu_kernel.work(64, 32, 4, torch.float32, stages=stages)
    full_bytes, full_ops = ctu_kernel.work(64, 32, 4, torch.float32)
    assert nbytes == full_bytes == 2 * 4 * 72 * 40 * 4
    assert nops == ctu_kernel.FLOPS_PER_ZONE_PREFIX[stages] * 64 * 32
    if stages < 4:
        assert nops < ctu_kernel.work(64, 32, 4, torch.float32,
                                      stages=stages + 1)[1]
    else:
        assert nops == full_ops
