"""Parity of the PyTorch port's shallow-water solver with pyro2_tpu.

The same inputs, made from a numpy seed or by pyro2_tpu's own problem
setup, go through the JAX functions (CPU, x64, tests/conftest.py; the jnp
path, never the f32 Pallas kernel) and their counterparts in
pyro2_tpu_torch (CPU, float64).  Tolerances:
  * cons_to_prim / prim_to_cons: 1e-14 of max|x| (one rounding at most);
  * interface states, Riemann fluxes, transverse corrections:
    1e-12 of max|x|;
  * unsplit fluxes and one plain step vs sim._make_step(): 1e-12 of max|F|
    and of max|U|;
  * 10 Pyro steps of quad and kh: dt to 1e-12, state to 1e-10 of max|U|.
Each trap of the JAX swe path (the approximate 1/3 of the tracing, the
second a2, the ev >= 0 gate, the shifted left state, the Riemann window,
the ignored solid flags, Roe's entropy fix, HLLC's branch order, the
transverse window, the limiters, no viscosity, no flattening, stale ghosts,
the interior-only CFL) is reached by one of these inputs, so a change of
the port at that point fails a test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu.mesh import reconstruction as jrec
from pyro2_tpu.mesh.grid import Cartesian2d as JCartesian2d
from pyro2_tpu.mesh.indexer import ai as jai
from pyro2_tpu.mesh.indexer import embed as jembed
from pyro2_tpu.solvers.swe import interface as jifc
from pyro2_tpu.solvers.swe import simulation as jswe
from pyro2_tpu.solvers.swe import unsplit_fluxes as jflx
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.mesh import reconstruction as trec
from pyro2_tpu_torch.mesh.grid import Cartesian2d
from pyro2_tpu_torch.solvers.swe import interface as tifc
from pyro2_tpu_torch.solvers.swe import simulation as tswe
from pyro2_tpu_torch.solvers.swe import swe_kernel
from pyro2_tpu_torch.solvers.swe import unsplit_fluxes as tflx
from pyro2_tpu_torch.util.carry import carry_simulation

GRAV = 1.0


class IV:
    """swe variable indices for nvar variables (fuel and nvar - 4 more
    passive scalars), in the Simulation's registration order."""

    def __init__(self, nvar):
        self.nvar = nvar
        self.ih, self.ixmom, self.iymom = 0, 1, 2
        self.naux = nvar - 3
        self.ihx = 3
        self.nq = nvar
        self.iu, self.iv = 1, 2
        self.ix = 3


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(ref, got, rtol=1e-12):
    """max |got - ref| <= rtol max |ref| over the finite values; NaNs and
    infinities in the same places."""
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    fin = np.isfinite(ref)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.array_equal(ref[~fin], got[~fin], equal_nan=True)
    scale = max(np.abs(ref[fin]).max(), 1e-300)
    err = np.abs(got[fin] - ref[fin]).max()
    assert err <= rtol * scale, (err, scale)


def _grids(nx=16, ny=12):
    return JCartesian2d(nx, ny, ng=4), Cartesian2d(nx, ny, ng=4)


# -- cons <-> prim ----------------------------------------------------------

@pytest.mark.parametrize("nvar", [4, 5])
def test_cons_prim_match_jax(nvar):
    iv = IV(nvar)
    jg, g = _grids()
    rng = np.random.default_rng(nvar)
    U = rng.standard_normal((nvar, g.qx, g.qy))
    U[0] = 0.5 + rng.random((g.qx, g.qy))
    U[0, ::5, ::3] = 0.0                       # h == 0 cells
    jq = jswe.cons_to_prim(jnp.asarray(U), iv, jg)
    tq = tswe.cons_to_prim(torch.as_tensor(U), iv, g)
    _close(jq, tq, 1e-14)
    assert not tq[1:, ::5, ::3].any()          # the guard zeroes them
    jU = jswe.prim_to_cons(jq, iv, jg)
    tU = tswe.prim_to_cons(tq, iv, g)
    _close(jU, tU, 1e-14)


# -- tracing ----------------------------------------------------------------

def _random_prims(g, rng, nvar=5):
    shape = (g.qx, g.qy)
    h = 0.5 + rng.random(shape)
    u = rng.standard_normal(shape)
    v = rng.standard_normal(shape)
    # stationary waves: ev == 0 gates fully left
    u[::2, :] = 0.0
    v[:, ::2] = 0.0
    X = rng.random((nvar - 3,) + shape)
    return np.concatenate([np.stack([h, u, v]), X])


@pytest.mark.parametrize("limiter", [0, 1, 2])
@pytest.mark.parametrize("idir", [1, 2])
def test_states_match_jax(idir, limiter):
    iv = IV(5)
    jg, g = _grids()
    rng = np.random.default_rng(10 * idir + limiter)
    q = _random_prims(g, rng)
    jdq = jnp.stack([jrec.limit(jnp.asarray(q[n]), jg, idir, limiter)
                     for n in range(iv.nq)])
    tdq = torch.stack([trec.limit(torch.as_tensor(q[n]), g, idir, limiter)
                       for n in range(iv.nq)])
    _close(jdq, tdq)
    dt = 0.02
    dx = g.dx if idir == 1 else g.dy
    jl, jr = jifc.states(idir, jg, dx, dt, iv, GRAV, jnp.asarray(q), jdq)
    tl, tr = tifc.states(idir, g, dx, dt, iv, GRAV, torch.as_tensor(q), tdq)
    _close(jl, tl)
    _close(jr, tr)
    # the left state sits one zone up along idir: its window ends at
    # hi + 3, the right state's at hi + 2
    hi = (g.ihi if idir == 1 else g.jhi) + 3
    edge = (slice(None), hi) if idir == 1 else (slice(None), slice(None), hi)
    assert tl[edge].abs().max() > 0 and not tr[edge].any()


# -- Riemann solvers --------------------------------------------------------

# velocities in units of the wave speed, one per row of the frame: the
# four HLLC regions (supersonic either way, subsonic either way) and
# transonic states for Roe's entropy fix on lam0 (+1) and lam2 (-1)
MACH = np.array([-3.0, -0.3, 0.3, 3.0, 1.0, -1.0, 1.0, -1.0])


def _riemann_states(g, rng, nvar=5):
    shape = (g.qx, g.qy)
    mach = MACH[np.arange(g.qx) % len(MACH)][:, None] * np.ones(shape)
    h_l = 0.5 + rng.random(shape)
    h_r = h_l * (1.0 + 0.02 * rng.standard_normal(shape))
    out = []
    for h in (h_l, h_r):
        c = np.sqrt(GRAV * h)
        un = mach * c + 0.01 * rng.standard_normal(shape)
        ut = rng.standard_normal(shape)
        X = rng.random((nvar - 3,) + shape)
        out.append([h, un, ut, X])
    # every fifth column mirrors h and un across the face: HLLC's contact
    # speed S_c is then exactly 0, the tie its ladder sends to F*_r
    mirror = (slice(None), slice(0, None, 5))
    out[1][0][mirror] = out[0][0][mirror]
    out[1][1][mirror] = -out[0][1][mirror]
    return out


def _cons(h, un, ut, X, idir):
    u, v = (un, ut) if idir == 1 else (ut, un)
    return np.concatenate([np.stack([h, h * u, h * v]), h * X])


def _window(a, g):
    return a[..., g.ilo - 1:g.ihi + 2, g.jlo - 1:g.jhi + 2]


def _roe_eigen(left, right, g):
    """lam0 and lam2 of the Roe average on the solvers' window."""
    (h_l, un_l, _, _), (h_r, un_r, _, _) = [
        tuple(_window(a, g) for a in s) for s in (left, right)]
    sq_l, sq_r = np.sqrt(h_l), np.sqrt(h_r)
    un_roe = (h_l * un_l / sq_l + h_r * un_r / sq_r) / (sq_l + sq_r)
    c_roe = np.sqrt(0.5 * GRAV * (h_l + h_r))
    return un_roe - c_roe, un_roe + c_roe


def _hllc_regions(left, right, g):
    """Which of HLLC's four fluxes each interface of the window takes, and
    the contact speed S_c."""
    (h_l, un_l, _, _), (h_r, un_r, _, _) = [
        tuple(_window(a, g) for a in s) for s in (left, right)]
    c_l, c_r = np.sqrt(GRAV * h_l), np.sqrt(GRAV * h_r)
    h_avg, c_avg = 0.5 * (h_l + h_r), 0.5 * (c_l + c_r)
    hstar = h_avg - 0.25 * (un_r - un_l) * h_avg / c_avg
    with np.errstate(invalid="ignore"):   # the branch not taken
        S_l = np.where(hstar <= h_l, un_l - c_l,
                       un_l - c_l * np.sqrt(0.5 * (hstar + h_l) * hstar) /
                       h_l)
        S_r = np.where(hstar <= h_r, un_r + c_r,
                       un_r + c_r * np.sqrt(0.5 * (hstar + h_r) * hstar) /
                       h_r)
    S_c = (S_l * h_r * (un_r - S_r) - S_r * h_l * (un_l - S_l)) / \
        (h_r * (un_r - S_r) - h_l * (un_l - S_l))
    return np.select([S_r <= 0.0, (S_c <= 0.0) & (S_r > 0.0),
                      (S_l < 0.0) & (S_c > 0.0)], [0, 1, 2], 3), S_c


@pytest.mark.parametrize("walls", [(0, 0), (1, 1)])
@pytest.mark.parametrize("idir", [1, 2])
@pytest.mark.parametrize("solver", ["Roe", "HLLC"])
def test_riemann_matches_jax(solver, idir, walls):
    iv = IV(5)
    jg, g = _grids()
    rng = np.random.default_rng(7 * idir)
    left, right = _riemann_states(g, rng)
    U_l, U_r = _cons(*left, idir), _cons(*right, idir)

    if solver == "Roe":
        lam0, lam2 = _roe_eigen(left, right, g)
        for lam in (lam0, lam2):
            # the entropy fix fires, and the threshold 0.01 matters
            assert (np.abs(lam) < 0.01).sum() >= 1
            assert ((np.abs(lam) >= 0.01) & (np.abs(lam) < 0.1)).sum() >= 1
    else:
        regions, S_c = _hllc_regions(left, right, g)
        assert set(np.unique(regions)) == {0, 1, 2, 3}
        assert ((S_c == 0.0) & (regions == 1)).sum() >= 3

    jf = {"Roe": jifc.riemann_roe, "HLLC": jifc.riemann_hllc}[solver]
    tf = {"Roe": tifc.riemann_roe, "HLLC": tifc.riemann_hllc}[solver]
    ja = jf(idir, jg, iv, walls[0], walls[1], GRAV, jnp.asarray(U_l),
            jnp.asarray(U_r))
    ta = tf(idir, g, iv, walls[0], walls[1], GRAV, torch.as_tensor(U_l),
            torch.as_tensor(U_r))
    _close(ja, ta)
    # zero outside [ilo-1, ihi+1]^2, and the solid flags change nothing
    inner = torch.zeros_like(ta, dtype=torch.bool)
    inner[:, g.ilo - 1:g.ihi + 2, g.jlo - 1:g.jhi + 2] = True
    assert not ta[~inner].any()
    assert float((ta[inner] != 0).double().mean()) > 0.5
    free = tf(idir, g, iv, 0, 0, GRAV, torch.as_tensor(U_l),
              torch.as_tensor(U_r))
    assert torch.equal(free, ta)


@pytest.mark.parametrize("idir", [1, 2])
def test_cons_flux_guard_matches_jax(idir):
    iv = IV(4)
    jg, g = _grids()
    rng = np.random.default_rng(idir)
    U = rng.standard_normal((4, g.qx, g.qy))
    U[0] = 0.5 + rng.random((g.qx, g.qy))
    U[0, 3::4, 2::5] = 0.0
    # consFlux guards h == 0 zones; the solvers' window flux does not
    _close(jifc.consFlux(idir, GRAV, iv, jnp.asarray(U)),
           tifc.consFlux(idir, GRAV, iv, torch.as_tensor(U)))
    jw = jifc._consFlux_win(idir, GRAV, iv, jnp.asarray(U))
    tw = tifc._consFlux_win(idir, GRAV, iv, torch.as_tensor(U))
    assert np.isnan(_np(tw)).any()
    _close(jw, tw)


def _jax_corrections(U_xl, U_xr, U_yl, U_yr, F_x, F_y, g, dt):
    """The transverse corrections as pyro2_tpu/solvers/swe/
    unsplit_fluxes.py:65-78 write them."""
    b = (2, 1)
    Fx, Fy = jai(F_x, g), jai(F_y, g)
    dtdx, dtdy = dt / g.dx, dt / g.dy
    U_xl = U_xl + jembed(-0.5 * dtdy * (Fy.ip_jp(-1, 1, buf=b) -
                                        Fy.ip(-1, buf=b)), g, b)
    U_xr = U_xr + jembed(-0.5 * dtdy * (Fy.jp(1, buf=b) - Fy.v(buf=b)),
                         g, b)
    U_yl = U_yl + jembed(-0.5 * dtdx * (Fx.ip_jp(1, -1, buf=b) -
                                        Fx.jp(-1, buf=b)), g, b)
    U_yr = U_yr + jembed(-0.5 * dtdx * (Fx.ip(1, buf=b) - Fx.v(buf=b)),
                         g, b)
    return U_xl, U_xr, U_yl, U_yr


def test_transverse_corrections_match_jax():
    jg, g = _grids()
    rng = np.random.default_rng(11)
    shape = (5, g.qx, g.qy)
    states = [rng.standard_normal(shape) for _ in range(4)]
    # first-pass fluxes are zero outside [ilo-1, ihi+1]^2
    fluxes = [np.array(jembed(jnp.asarray(_window(
        rng.standard_normal(shape), g)), jg, 1)) for _ in range(2)]
    dt = 0.01
    ref = _jax_corrections(*map(jnp.asarray, states + fluxes), jg, dt)
    got = tflx.transverse_corrections(*map(torch.as_tensor, states + fluxes),
                                      g, dt)
    win = np.zeros(shape, dtype=bool)
    win[:, g.ilo - 2:g.ihi + 2, g.jlo - 2:g.jhi + 2] = True
    for r, t, s in zip(ref, got, states):
        _close(r, t)
        # the window is lo 2, hi 1 on both axes, for every state
        d = t.numpy() - s
        assert not d[~win].any()
        assert (d[win] != 0).mean() > 0.8


# -- one plain step ---------------------------------------------------------

STEP_CASES = {
    "quad_roe_lim2_outflow": ("quad", {"mesh.nx": 16, "mesh.ny": 12,
                                       "swe.riemann": "Roe",
                                       "swe.limiter": 2}, None),
    "kh_hllc_periodic": ("kh", {"mesh.nx": 16, "mesh.ny": 12}, None),
    "dam_x_roe_lim1_walls": ("dam", {"mesh.nx": 24, "mesh.ny": 12,
                                     "mesh.ymax": 0.5}, None),
    "advect_lim0_grav": ("advect", {"mesh.nx": 16, "mesh.ny": 12}, None),
    "quad_hllc_passive": ("quad", {"mesh.nx": 16, "mesh.ny": 12,
                                   "swe.riemann": "HLLC"}, ["passive"]),
}


def _jax_sim(problem, inputs, extra_vars=None, steps=2):
    """A JAX swe simulation after `steps` steps, ghosts filled."""
    p = JPyro("swe")
    p.initialize_problem(problem, inputs_dict=inputs)
    sim = p.sim
    if extra_vars:
        sim = jswe.Simulation("swe", problem, p.problem_func, p.rp)
        sim.initialize(extra_vars=extra_vars)
        rng = np.random.default_rng(5)
        h = np.asarray(sim.cc_data.get_var("height"))
        for name in extra_vars:
            sim.cc_data.set_var(name, h * rng.random(h.shape))
        sim.cc_data.t = 0.0
    for _ in range(steps):
        sim.cc_data.fill_BC_all()
        sim.compute_timestep()
        sim.evolve()
    sim.cc_data.fill_BC_all()
    return sim


def _carry(jsim, extra_vars=None):
    return carry_simulation("swe", jsim.problem_name, jsim.rp.params,
                            np.asarray(jsim.cc_data.data),
                            t=float(jsim.cc_data.t), n=jsim.n,
                            extra_vars=extra_vars, device="cpu")


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_plain_step_matches_jax(case):
    problem, inputs, extra = STEP_CASES[case]
    jsim = _jax_sim(problem, inputs, extra)
    tsim = _carry(jsim, extra)
    assert tsim.cc_data.names == jsim.cc_data.names    # fuel carried
    assert tsim.ivars.nvar == (5 if extra else 4)
    U0 = tsim.cc_data.data.clone()

    dtj = float(jsim._make_dt()(jsim.cc_data.data))
    dtt = float(tsim._make_dt()(tsim.cc_data.data))
    assert abs(dtj - dtt) <= 1e-14 * dtj
    dt = 0.8 * dtj
    t = jsim.cc_data.t

    jF = jflx.unsplit_fluxes(jsim.cc_data.data, jsim.cc_data, jsim.rp,
                             jsim.ivars, jsim.solid, jsim.tc, dt)
    tF = tflx.unsplit_fluxes(tsim.cc_data.data, tsim.cc_data, tsim.rp,
                             tsim.ivars, tsim.solid, tsim.tc, dt)
    for a, b in zip(jF, tF):
        _close(a, b)

    Uj = jax.jit(jsim._make_step())(jsim.cc_data.data, t, dt)
    Ut = tsim._make_step()(tsim.cc_data.data, t, dt)
    assert torch.equal(tsim.cc_data.data, U0)          # the step is pure
    _close(Uj, Ut)
    # the update leaves the ghosts as they were (stale until the next fill)
    g = tsim.cc_data.grid
    ghost = torch.ones(U0.shape[1:], dtype=torch.bool)
    ghost[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = False
    assert torch.equal(Ut[:, ghost], U0[:, ghost])

    # the kernel wrapper takes the plain step for CPU tensors
    assert isinstance(tsim._step, swe_kernel.SWEStep)
    before = swe_kernel.launches
    assert torch.equal(tsim._step(tsim.cc_data.data, t, dt), Ut)
    assert swe_kernel.launches == before


def test_dt_is_the_interior_minimum():
    jsim = _jax_sim("quad", {"mesh.nx": 16, "mesh.ny": 12}, steps=0)
    U = np.array(jsim.cc_data.data)
    g = jsim.cc_data.grid
    U[1, g.ilo - 1, g.jlo + 3] = 1.0e3 * U[0, g.ilo - 1, g.jlo + 3]
    U[2, g.ilo + 2, g.jhi + 2] = -1.0e3 * U[0, g.ilo + 2, g.jhi + 2]
    jsim.cc_data.set_vars(jnp.asarray(U))
    tsim = _carry(jsim)
    dtj = float(jsim._make_dt()(jsim.cc_data.data))
    dtt = float(tsim._make_dt()(tsim.cc_data.data))
    assert abs(dtj - dtt) <= 1e-14 * dtj
    # the fast ghost cells would have cut it by orders of magnitude
    assert dtt > 100.0 * g.dx / 1.0e3


@pytest.mark.parametrize("problem", ["quad", "kh"])
def test_runs_match_jax(problem):
    inputs = {"mesh.nx": 32, "mesh.ny": 32, "driver.max_steps": 10,
              "driver.tmax": 10.0}
    pj = JPyro("swe")
    pj.initialize_problem(problem, inputs_dict=inputs)
    pt = Pyro("swe", device="cpu")
    pt.initialize_problem(problem, inputs_dict=inputs)
    assert pt.sim.cc_data.data.dtype == torch.float64
    dts_j, dts_t = [], []
    for _ in range(10):
        pj.single_step()
        pt.single_step()
        dts_j.append(pj.sim.dt)
        dts_t.append(pt.sim.dt)
    np.testing.assert_allclose(dts_t, dts_j, rtol=1e-12, atol=0)
    g = pt.sim.cc_data.grid
    sl = (slice(None), slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
    a = np.asarray(pj.sim.cc_data.data)[sl]
    b = pt.sim.cc_data.data.numpy()[sl]
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    assert pt.sim.n == 10


# -- problems, derived variables --------------------------------------------

PROBLEMS = [("acoustic_pulse", None), ("advect", None), ("dam", None),
            ("dam", "inputs.dam.y"), ("kh", None), ("quad", None),
            ("test", None)]


@pytest.mark.parametrize("problem,inputs_file", PROBLEMS)
def test_problem_setup_matches_jax(problem, inputs_file):
    inputs = {"mesh.nx": 16, "mesh.ny": 12}
    pj = JPyro("swe")
    pj.initialize_problem(problem, inputs_file=inputs_file,
                          inputs_dict=inputs)
    pt = Pyro("swe", device="cpu")
    pt.initialize_problem(problem, inputs_file=inputs_file,
                          inputs_dict=inputs)
    assert pt.sim.cc_data.names == pj.sim.cc_data.names
    np.testing.assert_array_equal(pt.sim.cc_data.data.numpy(),
                                  np.asarray(pj.sim.cc_data.data))
    for name in ("velocity", "primitive", "soundspeed"):
        ref = pj.sim.cc_data.get_var(name)
        got = pt.sim.cc_data.get_var(name)
        ref = ref if isinstance(ref, list) else [ref]
        got = got if isinstance(got, list) else [got]
        assert len(ref) == len(got)
        for r, t in zip(ref, got):
            _close(r, t, 1e-14)


def test_logo_setup():
    # under numpy >= 2 the JAX package's logo raises OverflowError on
    # 256 - uint8; the port widens the channel first, as numpy 1 did
    pytest.importorskip("matplotlib")
    p = Pyro("swe", device="cpu")
    p.initialize_problem("logo", inputs_dict={"mesh.nx": 64, "mesh.ny": 64})
    g = p.get_grid()
    h = p.get_var("height")[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]
    assert float(h.min()) >= 1.0 and float(h.max()) <= 1.0 + 256 / 255
    assert float(h.max()) > 1.5                 # the text is drawn
    fuel = p.get_var("fuel")
    H = p.get_var("height")
    assert torch.equal(fuel, H ** 2 / H.max())


# -- the kernel wrapper and what it refuses ---------------------------------

def test_kernel_wrapper_checks_inputs():
    jsim = _jax_sim("quad", {"mesh.nx": 16, "mesh.ny": 12}, steps=0)
    tsim = _carry(jsim)
    step = tsim._step
    U = tsim.cc_data.data
    before = swe_kernel.launches
    with pytest.raises(TypeError):
        step(U.to(torch.float16), 0.0, 1e-4)
    with pytest.raises(ValueError):
        step(U[:, 1:, :].contiguous(), 0.0, 1e-4)
    with pytest.raises(ValueError):
        step(U.permute(0, 2, 1).contiguous().permute(0, 2, 1), 0.0, 1e-4)
    with pytest.raises(ValueError):
        step(torch.empty(U.shape, dtype=U.dtype, device="meta"), 0.0, 1e-4)
    with pytest.raises(ValueError):
        step.launch(U, 0.0, 1e-4)      # the CUDA kernel on a CPU tensor
    assert swe_kernel.launches == before


@pytest.mark.parametrize("inputs,extra,error", [
    ({"swe.use_flattening": 1}, None, NotImplementedError),
    ({}, ["s1", "s2", "s3", "s4", "s5"], NotImplementedError),
    ({"swe.riemann": "CGF"}, None, ValueError),
])
def test_uncovered_configurations_raise(inputs, extra, error):
    p = Pyro("swe", device="cpu")
    p.initialize_problem("quad", inputs_dict={"mesh.nx": 8, "mesh.ny": 8})
    for k, v in inputs.items():
        p.rp.set_param(k, v)
    sim = tswe.Simulation("swe", "quad", p.problem_func, p.rp,
                          device="cpu")
    with pytest.raises(error, match="ROADMAP|Riemann"):
        sim.initialize(extra_vars=extra)


def test_particles_match_jax():
    """Random particles on quad 16x16 (one numpy seed for both packages)
    advance with the derived velocity after each step: positions at rtol
    1e-12 and `active` equal to the JAX package's after 5 steps (the
    particles case of test_uncovered_configurations_raise, which raised
    before particles were ported)."""
    inputs = {"mesh.nx": 16, "mesh.ny": 16, "particles.do_particles": 1,
              "particles.particle_generator": "random",
              "particles.n_particles": 50}
    runs = []
    for P, kw in ((Pyro, {"device": "cpu"}), (JPyro, {})):
        np.random.seed(2)
        p = P("swe", **kw)
        p.initialize_problem("quad", inputs_dict=dict(inputs))
        for _ in range(5):
            p.single_step()
        runs.append(p.sim.particles)
    tp, jp = runs
    np.testing.assert_allclose(tp.positions.numpy(),
                               np.asarray(jp.positions), rtol=1e-12)
    assert np.array_equal(tp.active.numpy(), np.asarray(jp.active))
    assert not np.array_equal(tp.positions.numpy(),
                              tp.init_positions.numpy())


def test_work_counts_state_bytes_and_operations():
    nbytes, nops = swe_kernel.work(1024, 1024, 4, torch.float32, "Roe")
    assert nbytes == 2 * 4 * 1032 * 1032 * 4
    assert nops == swe_kernel.flops_per_zone("Roe") * 1024 * 1024
    assert swe_kernel.flops_per_zone("HLLC") < \
        swe_kernel.flops_per_zone("Roe")
