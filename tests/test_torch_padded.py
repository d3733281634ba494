"""Parity of the port's padded-frame CTU steps (solvers/compressible/
padded_step.py) and its ensemble tier (parallel/ensemble.py) with
pyro2_tpu.

The JAX entries are make_pallas_ctu_step_padded (row 2),
make_pallas_ctu_step (row 3) and make_pallas_ctu_ensemble_step (row 4) of
pyro2_tpu/solvers/compressible/pallas_step.py.  Tolerances:
  * row 3's plain step, whose rp asks for gravity, a sponge and a floor
    that the entry ignores, against the JAX jnp step of a Simulation with
    none of them, float64: max |diff| <= 1e-12 max|U| on the interior;
  * rows 2 and 4 against the JAX Pallas kernels in interpret mode (float32
    only; built with tile_rows=8, since the default 128 fails their own
    nx % tile_rows assertion at 32^2), float32: 1e-5 max|U| (float32
    rounding through one CTU step);
  * the periodic fill against the JAX fill: bit for bit, corners included;
  * each member of a batch against its own one-member step: bit for bit;
  * ensemble_step against JAX's with a jnp step: rtol 1e-13 (JAX's own
    ensemble test's bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu.parallel.ensemble import ensemble_states as jensemble_states
from pyro2_tpu.parallel.ensemble import ensemble_step as jensemble_step
from pyro2_tpu.solvers.compressible import pallas_step
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.parallel import ensemble_states, ensemble_step
from pyro2_tpu_torch.solvers.compressible import padded_step

PERIODIC = {"mesh.xlboundary": "periodic", "mesh.xrboundary": "periodic",
            "mesh.ylboundary": "periodic", "mesh.yrboundary": "periodic",
            "driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0}
NG = 4


def _jax_sim(problem, n, extra=None):
    p = JPyro("compressible")
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": n, "mesh.ny": n, **PERIODIC,
        "compressible.small_dens": -1.e30, **(extra or {})})
    p.sim.cc_data.fill_BC_all()
    return p.sim


def _args(sim):
    g = sim.cc_data.grid
    return (g.nx, g.ny, g.dx, g.dy, sim.rp.get_param("eos.gamma"),
            dict(sim.rp.params), sim.ivars)


def _interior(U):
    U = U.numpy() if isinstance(U, torch.Tensor) else np.asarray(U)
    return U[..., NG:-NG, NG:-NG]


def _close(a, b, tol):
    a, b = _interior(a), _interior(b)
    assert np.abs(a - b).max() <= tol * np.abs(a).max()


def test_row3_ignores_gravity_sponge_and_floor():
    """Trap: the grav, sponge, small_dens and walls in rp have no effect
    on the padded entries (pallas_step.py:41-43, 301-302)."""
    jsim = _jax_sim("kh", 32)
    U0 = jsim.cc_data.data
    dt = 0.8 * float(jsim._make_dt()(U0))
    ref = jax.jit(jsim._make_step())(U0, 0.0, dt)

    nx, ny, dx, dy, gamma, params, ivars = _args(jsim)
    params.update({"compressible.grav": 1.0, "sponge.do_sponge": 1,
                   "sponge.sponge_rho_begin": 1.5,
                   "sponge.sponge_rho_full": 1.2,
                   "compressible.small_dens": 1.5})
    step = padded_step.make_ctu_step(nx, ny, dx, dy, gamma, params, ivars)
    U = torch.as_tensor(np.array(U0))
    got = step(U, dt)
    _close(ref, got, 1e-12)
    assert torch.equal(got[:, :NG], U[:, :NG])          # ghosts kept
    assert torch.equal(got[:, :, -NG:], U[:, :, -NG:])
    assert padded_step.launches["ctu_padin"] == 0       # CPU: the plain step
    # the floor would have acted on this state
    assert float(_interior(U)[ivars.idens].min()) < 1.5


def _jax_padded(jsim, n_ens=None):
    args = _args(jsim)
    if n_ens is None:
        return pallas_step.make_pallas_ctu_step_padded(
            *args, tile_rows=8, interpret=True)
    return pallas_step.make_pallas_ctu_ensemble_step(
        n_ens, *args, tile_rows=8, interpret=True)


def test_row2_matches_pallas_interpret():
    jsim = _jax_sim("advect", 32)
    to_j, from_j, fill_j, step_j = _jax_padded(jsim)
    U0 = jsim.cc_data.data
    dt = np.float32(0.8 * float(jsim._make_dt()(U0)))
    ref = np.asarray(from_j(step_j(fill_j(to_j(U0)), dt)))

    to_p, from_p, fill, step = padded_step.make_ctu_step_padded(
        *_args(jsim))
    P = to_p(torch.as_tensor(np.array(U0), dtype=torch.float32))
    assert P.dtype == torch.float32
    got = from_p(step(fill(P), float(dt)))
    _close(ref, got, 1e-5)


def test_row4_matches_pallas_interpret():
    jsim = _jax_sim("acoustic_pulse", 32)
    U0 = np.asarray(jsim.cc_data.data)
    members = [U0, np.roll(U0, 5, -1)]
    to_j, from_j, fill_j, step_j = _jax_padded(jsim, n_ens=2)
    dt = np.float32(1e-3)
    ref = np.asarray(from_j(step_j(fill_j(to_j(jnp.stack(members))), dt)))

    to_p, from_p, fill, step = padded_step.make_ctu_ensemble_step(
        2, *_args(jsim))
    P = to_p(torch.as_tensor(np.stack(members), dtype=torch.float32))
    got = from_p(step(fill(P), float(dt)))
    assert got.shape == ref.shape == (2, 4, 40, 40)
    for m in range(2):
        _close(ref[m], got[m], 1e-5)


@pytest.mark.parametrize("n_ens", [None, 3])
def test_fill_matches_jax_bit_for_bit(n_ens):
    """Trap: the y lanes are filled first over all rows, then the x rows
    over the full lane width, so the corners come from lane-filled rows
    (pallas_step.py:453-461)."""
    jsim = _jax_sim("advect", 16)
    rng = np.random.default_rng(3)
    shape = (4, 24, 24) if n_ens is None else (n_ens, 4, 24, 24)
    U = rng.standard_normal(shape).astype(np.float32)
    to_j, from_j, fill_j, _ = _jax_padded(jsim, n_ens)
    ref = np.asarray(from_j(fill_j(to_j(jnp.asarray(U)))))
    if n_ens is None:
        to_p, from_p, fill, _ = padded_step.make_ctu_step_padded(
            *_args(jsim))
    else:
        to_p, from_p, fill, _ = padded_step.make_ctu_ensemble_step(
            n_ens, *_args(jsim))
    got = from_p(fill(to_p(torch.as_tensor(U)))).numpy()
    assert np.array_equal(got, ref)
    assert not np.array_equal(got[..., :NG, :NG], U[..., :NG, :NG])


def _members(U0):
    return [U0, torch.roll(U0, 3, -1), torch.roll(U0, 5, -2)]


def test_ensemble_members_are_independent():
    """Trap: each member of a batch equals its own one-member step, bit
    for bit (float64, the plain steps)."""
    p = Pyro("compressible", device="cpu")
    p.initialize_problem("acoustic_pulse", inputs_dict={
        "mesh.nx": 24, "mesh.ny": 24, **PERIODIC})
    g, ivars = p.sim.cc_data.grid, p.sim.ivars
    args = (g.nx, g.ny, g.dx, g.dy, 1.4, p.rp.params, ivars)
    members = _members(p.sim.cc_data.data)
    to_e, from_e, fill_e, step_e = padded_step.make_ctu_ensemble_step(
        3, *args)
    to_1, from_1, fill_1, step_1 = padded_step.make_ctu_step_padded(*args)
    dt = 2e-3
    out = from_e(step_e(fill_e(to_e(ensemble_states(members))), dt))
    refs = [from_1(step_1(fill_1(to_1(U)), dt)) for U in members]
    for m, ref in enumerate(refs):
        assert torch.equal(out[m], ref)
    assert not torch.equal(refs[0], refs[1])
    # ensemble_step hands a batched step the whole stack: the same result
    estep = ensemble_step(step_e, fill_bc=fill_e)
    assert torch.equal(estep(to_e(ensemble_states(members)), dt), out)


def test_ensemble_step_matches_jax():
    jsim = _jax_sim("advect", 16)
    jstep = jsim._make_step()
    jfill = jsim.cc_data.fill_bc_stack
    U0 = jsim.cc_data.data
    jmembers = [U0, jnp.roll(U0, 3, axis=-1), jnp.roll(U0, 5, axis=-2)]
    dt = 1.e-3
    ref = np.asarray(jensemble_step(jstep, fill_bc=jfill)(
        jensemble_states(jmembers), 0.0, dt))

    p = Pyro("compressible", device="cpu")
    p.initialize_problem("advect", inputs_dict={
        "mesh.nx": 16, "mesh.ny": 16, **PERIODIC,
        "compressible.small_dens": -1.e30})
    sim = p.sim
    members = [torch.as_tensor(np.array(U)) for U in jmembers]
    got = ensemble_step(sim._step, fill_bc=sim.cc_data.fill_bc_stack)(
        ensemble_states(members), 0.0, dt)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13, atol=1e-14)


def test_padded_entries_check_and_refuse():
    jsim = _jax_sim("advect", 16)
    args = _args(jsim)
    _, _, _, step = padded_step.make_ctu_step_padded(*args)
    P = torch.zeros(step.shape, dtype=torch.float64)
    with pytest.raises(ValueError):
        step(P[:, 1:], 1e-3)
    with pytest.raises(TypeError):
        step(P.to(torch.int32), 1e-3)
    with pytest.raises(ValueError):
        step.launch(P, 1e-3)            # the CUDA kernel on a CPU tensor
    assert step.name == "ctu_periodic" and not step.batched
