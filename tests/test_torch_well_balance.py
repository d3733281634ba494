"""The well-balanced hydrostatic reconstruction of compressible_rk
(`compressible.well_balanced = 1`), held to pyro2_tpu in float64 on the
CPU.

  * reconstruction.well_balance alone against the JAX package's on seeded
    random stratified states and on hse's own state, bit for bit, and its
    refusal of every limiter but 1 (ValueError, as in JAX);
  * compressible_rk's fluxes with the reconstruction on a stratified
    state with a converging blast, whose shock turns the flattening on
    (xi < 1) where the well-balanced slope must stay unflattened, against
    the JAX package's at rtol 1e-12;
  * compressible_rk with well_balanced = 1 and limiter 1, on hse and on
    the Sedov blast under gravity (its shock turns the flattening on): 3
    steps through Pyro, the interior at rtol 1e-12 (atol 1e-12 max|U|).
    The reconstruction's traps show there: the well-balanced slope replaces the
    flattened one (xi does not multiply it), and the y faces' pressure is
    (p -+ p0_incr) -+ dp/2 with p0_incr = 0.5 dy rho grav; the run with the
    reconstruction off differs from it.
"""

import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu.mesh import reconstruction as jrec
from pyro2_tpu.mesh.grid import Cartesian2d as JCartesian2d
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.mesh import reconstruction as trec
from pyro2_tpu_torch.mesh.grid import Cartesian2d

OPTS = {"driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0,
        "driver.max_steps": 3, "driver.tmax": 1.0e30, "mesh.nx": 16,
        "mesh.ny": 48}
WB = {"compressible.well_balanced": 1, "compressible.limiter": 1}


class IV:
    nq = 4
    irho, iu, iv, ip = 0, 1, 2, 3


@pytest.mark.parametrize("grav", [-1.0, -2.5, 0.0])
@pytest.mark.parametrize("nx,ny", [(16, 48), (9, 23)])
def test_well_balance_matches_jax(grav, nx, ny):
    """A stratified state with random deviations (so every branch of the
    MC limiter is taken), bit for bit, zero outside the buf=2 window."""
    rng = np.random.default_rng(nx * 100 + ny)
    jg = JCartesian2d(nx, ny, ng=4, ymax=3.0)
    tg = Cartesian2d(nx, ny, ng=4, ymax=3.0)
    rho = np.exp(-jg.y2d) * (1.0 + 0.05 * rng.standard_normal(jg.x2d.shape))
    p = 2.0 * np.exp(-jg.y2d) + 0.02 * rng.standard_normal(jg.x2d.shape)
    q = np.stack([rho, rng.standard_normal(rho.shape),
                  rng.standard_normal(rho.shape), p])
    want = np.asarray(jrec.well_balance(q, jg, 1, IV, grav))
    got = trec.well_balance(torch.as_tensor(q), tg, 1, IV, grav)
    assert np.array_equal(got.numpy(), want)
    assert not got[:2].any() and not got[:, :2].any()
    assert got[2:-2, 2:-2].any()


def test_rk_fluxes_well_balanced_match_jax():
    from pyro2_tpu.solvers.compressible_rk import fluxes as jflx
    from pyro2_tpu.util.profile_pyro import TimerCollection as JTimers
    from pyro2_tpu_torch.mesh import reconstruction
    from pyro2_tpu_torch.solvers.compressible_rk import fluxes as tflx
    from pyro2_tpu_torch.util.profile_pyro import TimerCollection

    inputs = {**OPTS, **WB, "mesh.ny": 16}
    pj = JPyro("compressible_rk")
    pj.initialize_problem("hse", inputs_dict=inputs)
    pt = Pyro("compressible_rk", device="cpu")
    pt.initialize_problem("hse", inputs_dict=inputs)
    g = pj.sim.cc_data.grid
    # the hse atmosphere, ghosts filled, its pressure raised 6-fold across
    # a ramp two cells wide at mid-height, and a flow converging on it: a
    # steep, compressive jump that both one-sided differences see, so the
    # flattening is off (xi = 0) where the well-balanced slope is not zero
    pj.sim.cc_data.fill_BC_all()
    U = np.array(pj.sim.cc_data.data)
    iv = pj.sim.ivars
    gamma = pj.rp.get_param("eos.gamma")
    p = U[iv.iener] * (gamma - 1.0)                 # at rest
    p = p * (1.0 + 5.0 * np.clip((g.y2d - 0.45) / 0.1, 0.0, 1.0))
    U[iv.ixmom] = 0.0
    U[iv.iymom] = -2.0 * (g.y2d - 0.5) * U[iv.idens]
    U[iv.iener] = p / (gamma - 1.0) + 0.5 * U[iv.iymom] ** 2 / U[iv.idens]
    Ut = torch.as_tensor(U)

    class _Data:
        grid = pt.sim.cc_data.grid

    class _JData:
        grid = g

    want = jflx.fluxes(U, _JData(), pj.rp, iv, pj.sim.solid, JTimers())
    got = tflx.fluxes(Ut, _Data(), pt.rp, pt.sim.ivars, pt.sim.solid,
                      TimerCollection())
    for a, b in zip(want, got):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max())
    from pyro2_tpu_torch.solvers.compressible.simulation import cons_to_prim
    q = cons_to_prim(Ut, 1.4, pt.sim.ivars, pt.sim.cc_data.grid, check=False)
    tg = pt.sim.cc_data.grid
    xi = reconstruction.flatten_multid(
        tg, q, reconstruction.flatten(tg, q, 1, pt.sim.ivars, pt.rp),
        reconstruction.flatten(tg, q, 2, pt.sim.ivars, pt.rp), pt.sim.ivars)
    wb = reconstruction.well_balance(q, tg, 1, pt.sim.ivars,
                                     pt.rp.get_param("compressible.grav"))
    assert bool(((xi < 1.0) & (wb != 0.0)).any())


@pytest.mark.parametrize("limiter", [0, 2])
def test_well_balance_takes_limiter_1_alone(limiter):
    tg = Cartesian2d(8, 8, ng=4)
    q = torch.ones((4, tg.qx, tg.qy), dtype=torch.float64)
    with pytest.raises(ValueError, match="limiter == 1"):
        trec.well_balance(q, tg, limiter, IV, -1.0)
    with pytest.raises(ValueError, match="limiter == 1"):
        jrec.well_balance(q.numpy(), JCartesian2d(8, 8, ng=4), limiter, IV,
                          -1.0)


# hse at rest, and the Sedov blast under gravity, whose shock flattens the
# other slopes (xi < 1) where the well-balanced one must stay unflattened
RUNS = {"hse": {}, "sedov": {"mesh.ny": 16, "compressible.grav": -1.0}}


@pytest.mark.parametrize("problem", list(RUNS))
def test_rk_hse_well_balanced_matches_jax(problem):
    inputs = {**OPTS, **WB, **RUNS[problem]}
    pj = JPyro("compressible_rk")
    pj.initialize_problem(problem, inputs_dict=inputs)
    pt = Pyro("compressible_rk", device="cpu")
    pt.initialize_problem(problem, inputs_dict=inputs)
    assert np.array_equal(pt.sim.cc_data.data.numpy(),
                          np.asarray(pj.sim.cc_data.data))
    assert pt.sim._step.well_balanced and pt.sim._step.extended
    for _ in range(3):
        pj.single_step()
        pt.single_step()
    g = pt.get_grid()
    sl = (slice(None), slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
    a = np.asarray(pj.sim.cc_data.data)[sl]
    b = pt.sim.cc_data.data[sl].numpy()
    assert np.isfinite(a).all()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12 * np.abs(a).max())

    if problem != "hse":
        return
    # the same run without the reconstruction moves the atmosphere
    # differently
    po = Pyro("compressible_rk", device="cpu")
    po.initialize_problem(problem, inputs_dict={
        **inputs, "compressible.well_balanced": 0})
    for _ in range(3):
        po.single_step()
    assert not np.allclose(po.sim.cc_data.data[sl].numpy(), a, rtol=1e-12,
                           atol=1e-12 * np.abs(a).max())
