"""Parity of the port's spherical-geometry CTU solver with pyro2_tpu.

The same inputs, made from a numpy seed or by pyro2_tpu's own problem
setup, go through the JAX functions (CPU, x64, tests/conftest.py) and their
counterparts in pyro2_tpu_torch (CPU, float64) on SphericalPolar grids
(r in [0.5, 1], theta in [pi/4, 3 pi/4] unless stated).  Tolerances:
  * the pieces (tracing with the d(log A) source, the spherical artificial
    viscosity, CGF with its interface state, the area-weighted transverse
    corrections with their pressure gradients, both forms of the external
    sources): rtol 1e-12 of each output's largest value (the same float64
    operations; PyTorch divides a Python float by a tensor as a product with
    its reciprocal, a rounding apart);
  * one plain step against sim._make_step(): max |diff| <= 1e-12 max|U| on
    the interior;
  * advect through Pyro: 16^2 for 3 steps and 32^2 for 10 steps, every
    variable at rtol 1e-11 (atol 1e-12), the dt sequences to 1e-12;
  * one float32 plain step against the JAX package's Pallas kernel (row 1,
    spherical branch) in interpret mode: 1e-5 max|U|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu.mesh.grid import SphericalPolar as JSph
from pyro2_tpu.solvers.compressible import interface as jifc
from pyro2_tpu.solvers.compressible import riemann as jriemann
from pyro2_tpu.solvers.compressible import simulation as jcomp
from pyro2_tpu.solvers.compressible import unsplit_fluxes as jflx
from pyro2_tpu.util.profile_pyro import TimerCollection as JTimers
from pyro2_tpu.util.runparams import RuntimeParameters as JRP
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.mesh.grid import SphericalPolar
from pyro2_tpu_torch.solvers.compressible import ctu_kernel
from pyro2_tpu_torch.solvers.compressible import interface as tifc
from pyro2_tpu_torch.solvers.compressible import riemann as triemann
from pyro2_tpu_torch.solvers.compressible import simulation as tcomp
from pyro2_tpu_torch.solvers.compressible import unsplit_fluxes as tflx
from pyro2_tpu_torch.util.profile_pyro import TimerCollection
from pyro2_tpu_torch.util.runparams import RuntimeParameters
from test_torch_compressible import IV, _cons, _random_prims

GAMMA = 1.4
THETA = {"mesh.ymin": 0.7853981633974483, "mesh.ymax": 2.356194490192345}
SPH = {"mesh.grid_type": "SphericalPolar", "mesh.xmin": 0.5,
       "mesh.xmax": 1.0, **THETA,
       "mesh.xlboundary": "outflow", "mesh.xrboundary": "outflow",
       "mesh.ylboundary": "outflow", "mesh.yrboundary": "outflow",
       "compressible.riemann": "CGF"}


def _grids(nx=20, ny=28):
    kw = dict(ng=4, xmin=0.5, xmax=1.0, ymin=THETA["mesh.ymin"],
              ymax=THETA["mesh.ymax"])
    return JSph(nx, ny, **kw), SphericalPolar(nx, ny, **kw)


def _close(a, b, rtol=1e-12):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    scale = max(np.abs(a).max(), 1e-300)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale)


def _rps(riemann="CGF", grav=0.0):
    params = {"compressible.riemann": riemann, "eos.gamma": GAMMA,
              "compressible.grav": grav}
    jrp, trp = JRP(), RuntimeParameters()
    jrp.params, trp.params = dict(params), dict(params)
    return jrp, trp


class _D:
    def __init__(self, g):
        self.grid = g


class _Walls:
    def __init__(self, xl=0, xr=0, yl=0, yr=0):
        self.xl, self.xr, self.yl, self.yr = xl, xr, yl, yr


def _interior(U, g):
    U = U.numpy() if isinstance(U, torch.Tensor) else np.asarray(U)
    return U[:, g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]


# -- the pieces --------------------------------------------------------------

@pytest.mark.parametrize("idir", [1, 2])
def test_states_with_dloga_source_match_jax(idir):
    rng = np.random.default_rng(20 + idir)
    jg, tg = _grids()
    q = _random_prims(tg, rng, zero_u=True)
    dq = 0.1 * rng.standard_normal(q.shape)
    dt = 2e-2
    qt = torch.as_tensor(q)
    L, dloga = ("Lx", "dlogAx") if idir == 1 else ("Ly", "dlogAy")
    jl, jr = jifc.states(idir, jg, getattr(jg, L), getattr(jg, dloga), dt,
                         IV, GAMMA, jnp.asarray(q), jnp.asarray(dq))
    tl, tr = tifc.states(idir, tg, tg.tensor(L, qt), tg.tensor(dloga, qt),
                         dt, IV, GAMMA, qt, torch.as_tensor(dq))
    _close(jl, tl)
    _close(jr, tr)
    # the source acts: the Cartesian tracing of the same widths differs
    cl, _ = tifc.states(idir, tg, tg.tensor(L, qt), 0.0, dt, IV, GAMMA, qt,
                        torch.as_tensor(dq))
    assert float((cl[IV.irho] - tl[IV.irho]).abs().max()) > 1e-4


def test_artificial_viscosity_spherical_matches_jax():
    rng = np.random.default_rng(31)
    jg, tg = _grids()
    u = rng.standard_normal((tg.qx, tg.qy))
    v = rng.standard_normal((tg.qx, tg.qy))
    jx, jy = jifc.artificial_viscosity(jg, 0.1, jnp.asarray(u),
                                       jnp.asarray(v))
    tx, ty = tifc.artificial_viscosity(tg, 0.1, torch.as_tensor(u),
                                       torch.as_tensor(v))
    _close(jx, tx)
    _close(jy, ty)


@pytest.mark.parametrize("idir", [1, 2])
@pytest.mark.parametrize("walls", [(0, 0), (1, 1)])
def test_cgf_flux_and_interface_state_match_jax(idir, walls):
    rng = np.random.default_rng(7 + idir)
    jg, tg = _grids()
    q_l, q_r = _random_prims(tg, rng), _random_prims(tg, rng)
    q_r[3, ::3] *= 8.0
    U_l, U_r = _cons(q_l), _cons(q_r)
    jrp, trp = _rps()
    jF, jU = jriemann.riemann_flux(idir, jnp.asarray(U_l), jnp.asarray(U_r),
                                   _D(jg), jrp, IV, *walls, JTimers(),
                                   return_cons=True)
    tF, tU = triemann.riemann_flux(idir, torch.as_tensor(U_l),
                                   torch.as_tensor(U_r), _D(tg), trp, IV,
                                   *walls, TimerCollection(),
                                   return_cons=True)
    _close(jF, tF)
    _close(jU, tU)
    # no pressure in the spherical normal-momentum flux
    cart = triemann.consFlux(idir, 0, GAMMA, IV, tU)
    iun = IV.ixmom if idir == 1 else IV.iymom
    assert float((cart[iun] - tF[iun]).abs().max()) > 0.1


def test_hllc_lm_returns_no_interface_state():
    rng = np.random.default_rng(8)
    _, tg = _grids()
    U_l = torch.as_tensor(_cons(_random_prims(tg, rng)))
    U_r = torch.as_tensor(_cons(_random_prims(tg, rng)))
    _, trp = _rps("HLLC_lm")
    F = triemann.riemann_flux(1, U_l, U_r, _D(tg), trp, IV, 0, 0,
                              TimerCollection(), return_cons=True)
    assert isinstance(F, torch.Tensor) and F.shape == U_l.shape


def test_transverse_flux_spherical_matches_jax():
    rng = np.random.default_rng(41)
    jg, tg = _grids()
    states = [_cons(_random_prims(tg, rng)) for _ in range(4)]
    jrp, trp = _rps()
    dt = 1e-2
    jout = jflx.apply_transverse_flux(*[jnp.asarray(s) for s in states],
                                      _D(jg), jrp, IV, _Walls(), JTimers(),
                                      dt)
    tin = [torch.as_tensor(s.copy()) for s in states]
    tout = tflx.apply_transverse_flux(*tin, _D(tg), trp, IV, _Walls(),
                                      TimerCollection(), dt)
    for a, b in zip(jout, tout):
        _close(a, b)


@pytest.mark.parametrize("grav", [0.0, -0.7])
def test_external_sources_spherical_match_jax(grav):
    rng = np.random.default_rng(51)
    jg, tg = _grids()
    U = _cons(_random_prims(tg, rng))
    U_old = _cons(_random_prims(tg, rng))
    jrp, trp = _rps(grav=grav)
    dt = 1e-2
    for kw in ({}, {"U_old": U_old}):
        jS = jcomp.get_external_sources(
            0.0, dt, jnp.asarray(U), IV, jrp, jg,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        tS = tcomp.get_external_sources(
            0.0, dt, torch.as_tensor(U), IV, trp, tg,
            **{k: torch.as_tensor(v) for k, v in kw.items()})
        _close(jS, tS)
        # the geometric momentum terms act with grav = 0 too
        assert float(tS[IV.iymom].abs().max()) > 0.1
        assert float(tS[IV.ixmom].abs().max()) > 0.1
        assert float(tS[IV.idens].abs().max()) == 0.0


# -- the step and the solver -------------------------------------------------

def _jax_sim(inputs):
    p = JPyro("compressible")
    p.initialize_problem("advect", inputs_dict={
        "driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0, **inputs})
    sim = p.sim
    sim.cc_data.fill_BC_all()
    return sim


def _torch_sim(jsim, dtype=torch.float64):
    from pyro2_tpu_torch.solvers.compressible.problems import advect
    from pyro2_tpu_torch.util.carry import carry

    rp, U = carry(jsim.rp.params, np.asarray(jsim.cc_data.data),
                  device="cpu", dtype=dtype)
    sim = tcomp.Simulation("compressible", "advect", advect.init_data, rp,
                           device="cpu", dtype=dtype)
    sim.initialize()
    sim.cc_data.set_vars(U)
    sim.cc_data.t = 0.0
    return sim


def test_plain_step_with_radial_gravity_matches_jax():
    """Radial gravity, the geometric sources, a floor and the sponge on
    top of the spherical pipeline."""
    jsim = _jax_sim({**SPH, "mesh.nx": 24, "mesh.ny": 20,
                     "compressible.grav": -1.5,
                     "compressible.small_dens": 0.5,
                     "sponge.do_sponge": 1,
                     "sponge.sponge_rho_begin": 1.05,
                     "sponge.sponge_rho_full": 0.8})
    tsim = _torch_sim(jsim)
    g = tsim.cc_data.grid
    dt = 0.8 * float(jsim._make_dt()(jsim.cc_data.data))
    Uj = jax.jit(jsim._make_step())(jsim.cc_data.data, 0.0, dt)
    U0 = tsim.cc_data.data.clone()
    Ut = tsim._make_step()(tsim.cc_data.data, 0.0, dt)
    assert torch.equal(tsim.cc_data.data, U0)
    a, b = _interior(Uj, g), _interior(Ut, g)
    assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max()
    # the wrapper takes the plain step for CPU tensors
    assert torch.equal(tsim._step(tsim.cc_data.data, 0.0, dt), Ut)
    assert abs(float(tsim._make_dt()(tsim.cc_data.data)) -
               float(jsim._make_dt()(jsim.cc_data.data))) <= 1e-14 * dt


@pytest.mark.parametrize("n,steps", [(16, 3), (32, 10)])
def test_spherical_advect_through_pyro_matches_jax(n, steps):
    cfg = {**SPH, "mesh.nx": n, "mesh.ny": n, "driver.tmax": 1.0,
           "driver.max_steps": steps, "driver.verbose": 0}
    pj = JPyro("compressible")
    pj.initialize_problem("advect", inputs_dict=cfg)
    pt = Pyro("compressible", device="cpu")
    pt.initialize_problem("advect", inputs_dict=cfg)
    dts_j, dts_t = [], []
    for _ in range(steps):
        pj.single_step()
        pt.single_step()
        dts_j.append(pj.sim.dt)
        dts_t.append(pt.sim.dt)
    np.testing.assert_allclose(dts_t, dts_j, rtol=1e-12, atol=0)
    g = pt.sim.cc_data.grid
    for name in ("density", "x-momentum", "y-momentum", "energy"):
        a = np.asarray(pj.get_var(name))[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]
        b = pt.get_var(name)[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1].numpy()
        np.testing.assert_allclose(b, a, rtol=1e-11, atol=1e-12,
                                   err_msg=name)
    assert pt.sim.n == steps


def test_f32_plain_step_matches_pallas_interpret():
    """The JAX package's spherical kernel (test_compressible.py's
    TestSphericalFusedKernel configuration) against the port's float32
    plain step from the same filled state."""
    from pyro2_tpu.solvers.compressible.pallas_step import \
        make_pallas_ctu_step_padded_general

    jsim = _jax_sim({**SPH, "mesh.nx": 32, "mesh.ny": 32})
    to_p, from_p, fill_p, step_p = \
        make_pallas_ctu_step_padded_general(jsim, interpret=True)
    U0 = jsim.cc_data.data.astype(jnp.float32)
    dt = np.float32(1e-3)
    t = jnp.asarray(0.0, jnp.float32)
    Pf = fill_p(to_p(U0), t)
    got = np.asarray(from_p(step_p(Pf, t, jnp.asarray(dt))))

    tsim = _torch_sim(jsim, dtype=torch.float32)
    Uf = torch.as_tensor(np.array(from_p(Pf)))
    assert Uf.dtype == torch.float32
    Ut = tsim._make_step()(Uf, 0.0, float(dt))
    g = tsim.cc_data.grid
    a, b = _interior(got, g), _interior(Ut, g)
    assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


# -- the kernel wrapper on a spherical grid ----------------------------------

def test_kernel_wrapper_turns_the_spherical_terms_on():
    """The kernel's parameters: the spherical flag, and the sources on
    with grav = 0 (the geometric terms); its geometry buffer holds the
    grid's arrays where ctu_step.cu reads them."""
    jsim = _jax_sim({**SPH, "mesh.nx": 20, "mesh.ny": 12})
    tsim = _torch_sim(jsim)
    step = tsim._step
    assert tsim.rp.get_param("compressible.grav") == 0.0
    assert step.spherical and step.with_sources
    ints, _, S = step.kernel_args(tsim.cc_data.data, 0.0, 1e-3)
    assert ints[18] == 1 and ints[11] == 1
    assert S is not None and float(S[1].abs().max()) > 0.0

    g = tsim.cc_data.grid
    G = ctu_kernel.geometry(g, torch.float64, "cpu").numpy()
    plane = g.qx * g.qy
    planes = G[:4 * plane].reshape(4, g.qx, g.qy)
    for k, name in enumerate(("Ax", "Ay", "V", "dlogAy")):
        assert np.array_equal(planes[k], getattr(g, name))
    rows = G[4 * plane:4 * plane + 5 * g.qx].reshape(5, g.qx)
    assert np.array_equal(rows[0][:, None] * np.ones(g.qy), g.Ly)
    assert np.array_equal(rows[1][:, None] * np.ones(g.qy), g.dlogAx)
    assert np.array_equal(rows[2][:, None] * np.ones(g.qy), g.x2d)
    assert np.array_equal(rows[3], g.xl)
    assert np.array_equal(rows[4], g.x - g.dx)
    lanes = G[4 * plane + 5 * g.qx:].reshape(3, g.qy)
    assert np.array_equal(lanes[1], np.sin(g.y))
    nbytes, nops = ctu_kernel.work(g.nx, g.ny, 4, torch.float32, True, True)
    # state in and out, the S stack, the geometry
    assert nbytes == 4 * ((8 + 4 + 4) * plane + 5 * g.qx + 3 * g.qy)
    assert nops == ctu_kernel.FLOPS_PER_ZONE_SPHERICAL * g.nx * g.ny


def test_grid_tensors_are_copied_once_and_handed_out_fresh():
    """grid.tensor copies a host array to the device once per dtype and
    device and hands out a clone: a caller that writes into what it got
    does not change what the next caller gets."""
    _, g = _grids()
    like = torch.zeros((), dtype=torch.float32)
    first = g.tensor("Ly", like)
    assert first.dtype == torch.float32
    assert torch.equal(first, torch.as_tensor(g.Ly, dtype=torch.float32))
    first.fill_(-1.0)
    again = g.tensor("Ly", like)
    assert torch.equal(again, torch.as_tensor(g.Ly, dtype=torch.float32))
    assert again.data_ptr() != g.tensor("Ly", like).data_ptr()
    assert list(g._tensors) == [("Ly", torch.float32, like.device)]
