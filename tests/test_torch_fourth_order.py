"""Parity of the PyTorch port's 4th-order building blocks with pyro2_tpu.

The same inputs, made from a numpy seed, go through the JAX functions (CPU,
x64, tests/conftest.py) and their counterparts in pyro2_tpu_torch (CPU,
float64), to rtol 1e-12 (max |diff| <= 1e-12 max|ref|):
  * fourth_order.states and states_nolimit, both directions, two ragged
    grids, on data that holds smooth waves, noise, flat and linear patches
    (zero second differences) and sharp extrema, and on cubics through
    the edge cells, where the region masks (the d3a box reaching hi+3
    along x but hi+2 along y) decide the limiter.  The _sgn(0) = +1 rule,
    the tiny and d2af == 0 guards and the dolim thresholds are kept as
    written; changing any of them changes no result by more than about
    1e-12 of the local max|a| (they choose between branches that agree
    there, or avoid a 0/0 that is never selected), so no case can tell
    them apart at this tolerance;
  * fv.to_centers_array (with and without the positivity fallback) and
    from_centers_array;
  * riemann.riemann_prim (open and solid walls) and fv4 flux_cons;
  * RKIntegrator for RK2, TVD2, TVD3 and RK4: stage starts, stage times
    and the final update.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro2_tpu.mesh import fourth_order as jfo
from pyro2_tpu.mesh import fv as jfv
from pyro2_tpu.mesh import integration as jint
from pyro2_tpu.mesh import patch as jpatch
from pyro2_tpu.mesh.boundary import BC as JBC
from pyro2_tpu.mesh.grid import Cartesian2d as JCartesian2d
from pyro2_tpu.solvers.compressible import riemann as jriemann
from pyro2_tpu.solvers.compressible_fv4 import fluxes as jflx
from pyro2_tpu_torch.mesh import fourth_order as tfo
from pyro2_tpu_torch.mesh import fv as tfv
from pyro2_tpu_torch.mesh import integration as tint
from pyro2_tpu_torch.mesh import patch as tpatch
from pyro2_tpu_torch.mesh.boundary import BC as TBC
from pyro2_tpu_torch.mesh.grid import Cartesian2d
from pyro2_tpu_torch.solvers.compressible import riemann as triemann
from pyro2_tpu_torch.solvers.compressible_fv4 import fluxes as tflx

GAMMA = 1.4
GRIDS = [(20, 36), (33, 17)]


class IV:
    """Variable indices with one passive scalar (nvar = 5)."""
    nvar = 5
    idens, iener, ixmom, iymom = 0, 1, 2, 3
    naux = 1
    irhox = 4
    nq = 5
    irho, iu, iv, ip = 0, 1, 2, 3
    ix = 4


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(ref, got, rtol=1e-12):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(ref - got).max()
    assert err <= rtol * scale, (err, scale)


def _grids(nx, ny):
    return JCartesian2d(nx, ny, ng=4), Cartesian2d(nx, ny, ng=4)


def _field(g, rng):
    """Smooth waves plus noise, with flat and linear patches and spikes
    inside; the edges stay noisy, so the region masks there matter."""
    x, y = np.meshgrid(np.arange(g.qx), np.arange(g.qy), indexing="ij")
    a = np.sin(0.7 * x) * np.cos(0.45 * y) + \
        0.3 * rng.standard_normal((g.qx, g.qy))
    a[6:11, 6:11] = 1.25                        # flat: d2ac = d2af = 0
    a[12:17, 5:10] = 0.5 + 0.1 * y[12:17, 5:10]     # linear along y
    a[5:10, 12:17] = 0.2 * x[5:10, 12:17]           # linear along x
    a[14, 14] += 4.0                            # sharp extrema
    a[8, 20] -= 3.0
    return a


# -- fourth_order -------------------------------------------------------------

@pytest.mark.parametrize("idir", [1, 2])
@pytest.mark.parametrize("nx,ny", GRIDS)
def test_states_match_jax(idir, nx, ny):
    jg, tg = _grids(nx, ny)
    a = _field(tg, np.random.default_rng(nx + 3 * idir))
    jl, jr = jfo.states(jnp.asarray(a), jg, idir)
    tl, tr = tfo.states(torch.as_tensor(a), tg, idir)
    _close(jl, tl)
    _close(jr, tr)
    # zero outside the reference's loop ranges: the +1-shifted left box
    # and the m_W right box, along idir
    axis = 0 if idir == 1 else 1
    n = tl.shape[axis]
    assert not torch.any(tl.narrow(axis, 0, 1)).item()
    assert not torch.any(tr.narrow(axis, n - 1, 1)).item()


def _cubic(g, idir, rng, x0):
    """Random cubics along idir (random across it), centred at x0: their
    third differences are equal, so the limiter's dolim test at the edge
    cells turns on exactly the zeros the d3a region mask leaves there."""
    n_al = g.qx if idir == 1 else g.qy
    n_tr = g.qy if idir == 1 else g.qx
    t = (np.arange(n_al)[:, None] - x0) / 3.0
    c = rng.standard_normal((4, 1, n_tr))
    a = c[3] * t ** 3 + c[2] * t ** 2 + c[1] * t + c[0]
    return np.ascontiguousarray(a if idir == 1 else a.T)


@pytest.mark.parametrize("edge", ["lo", "hi"])
@pytest.mark.parametrize("idir", [1, 2])
@pytest.mark.parametrize("nx,ny", GRIDS)
def test_states_edge_masks_match_jax(idir, nx, ny, edge):
    # the d3a box reaches hi+3 along x but hi+2 along y, and starts at
    # lo-2: a cubic through the edge cell tells the masks apart
    jg, tg = _grids(nx, ny)
    hi = tg.ihi if idir == 1 else tg.jhi
    x0 = tg.ilo - 1 if edge == "lo" else hi + 1
    a = _cubic(tg, idir, np.random.default_rng(nx + idir), x0)
    jl, jr = jfo.states(jnp.asarray(a), jg, idir)
    tl, tr = tfo.states(torch.as_tensor(a), tg, idir)
    _close(jl, tl)
    _close(jr, tr)


@pytest.mark.parametrize("idir", [1, 2])
@pytest.mark.parametrize("nx,ny", GRIDS)
def test_states_nolimit_match_jax(idir, nx, ny):
    jg, tg = _grids(nx, ny)
    a = _field(tg, np.random.default_rng(7 * nx + idir))
    jl, jr = jfo.states_nolimit(jnp.asarray(a), jg, idir)
    tl, tr = tfo.states_nolimit(torch.as_tensor(a), tg, idir)
    _close(jl, tl)
    _close(jr, tr)


# -- fv conversions -----------------------------------------------------------

@pytest.mark.parametrize("is_positive", [False, True])
@pytest.mark.parametrize("nx,ny", GRIDS)
def test_to_centers_matches_jax(nx, ny, is_positive):
    jg, tg = _grids(nx, ny)
    rng = np.random.default_rng(nx)
    # small positive averages with spikes: the Laplacian drives some
    # centers negative, where is_positive keeps the average
    a = 0.05 + 0.01 * rng.random((tg.qx, tg.qy))
    a[10, 10] = 5.0
    a[15, 5] = 3.0
    ja = jfv.to_centers_array(jnp.asarray(a), jg, is_positive=is_positive)
    ta = torch.as_tensor(a)
    tc = tfv.to_centers_array(ta, tg, is_positive=is_positive)
    _close(ja, tc)
    assert np.array_equal(_np(ta), a)          # the input is left as it was
    if not is_positive:
        assert (_np(tc) < 0).any()


@pytest.mark.parametrize("nx,ny", GRIDS)
def test_from_centers_matches_jax(nx, ny):
    jg, tg = _grids(nx, ny)
    a = _field(tg, np.random.default_rng(nx + 1))
    _close(jfv.from_centers_array(jnp.asarray(a), jg),
           tfv.from_centers_array(torch.as_tensor(a), tg))


# -- riemann_prim and flux_cons -----------------------------------------------

def _prims(g, rng):
    shape = (g.qx, g.qy)
    q = np.stack([0.5 + rng.random(shape), rng.standard_normal(shape),
                  rng.standard_normal(shape), 0.5 + rng.random(shape),
                  rng.random(shape)])
    q[1, ::4] = 0.0        # resting states: ustar == 0 picks the mid state
    q[2, :, ::4] = 0.0
    return q


@pytest.mark.parametrize("idir", [1, 2])
@pytest.mark.parametrize("walls", [(0, 0), (1, 1)])
def test_riemann_prim_matches_jax(idir, walls):
    jg, tg = _grids(20, 36)
    rng = np.random.default_rng(11 + idir)
    q_l, q_r = _prims(tg, rng), _prims(tg, rng)
    # strong pressure jumps: shocks and rarefactions on both sides
    q_r[3, ::3] *= 8.0
    q_l[3, 1::3] *= 8.0
    ja = jriemann.riemann_prim(idir, jg, IV, walls[0], walls[1], GAMMA,
                               jnp.asarray(q_l), jnp.asarray(q_r))
    ta = triemann.riemann_prim(idir, tg, IV, walls[0], walls[1], GAMMA,
                               torch.as_tensor(q_l), torch.as_tensor(q_r))
    _close(ja, ta)


@pytest.mark.parametrize("idir", [1, 2])
def test_flux_cons_matches_jax(idir):
    _jg, tg = _grids(20, 36)
    q = _prims(tg, np.random.default_rng(5))
    _close(jflx.flux_cons(IV, idir, GAMMA, jnp.asarray(q)),
           tflx.flux_cons(IV, idir, GAMMA, torch.as_tensor(q)))


# -- RKIntegrator -------------------------------------------------------------

def _containers(nx, ny, U):
    jg, tg = _grids(nx, ny)
    jd = jpatch.CellCenterData2d(jg)
    td = tpatch.CellCenterData2d(tg, device="cpu")
    for name in ("a", "b"):
        jd.register_var(name, JBC(xlb="periodic", xrb="periodic",
                                  ylb="periodic", yrb="periodic"))
        td.register_var(name, TBC(xlb="periodic", xrb="periodic",
                                  ylb="periodic", yrb="periodic"))
    jd.create()
    td.create()
    jd.data = jnp.asarray(U)
    td.data = torch.as_tensor(U).clone()
    jd.t = td.t = 0.3
    return jd, td


def _rhs(U, t):
    """A nonlinear increment on the whole frame, ghosts included."""
    return np.ascontiguousarray(
        -0.7 * U * U[::-1] + np.cos(3.0 * t) * U[:, ::-1] + 0.1)


@pytest.mark.parametrize("method", ["RK2", "TVD2", "TVD3", "RK4"])
def test_rk_integrator_matches_jax(method):
    nx, ny = 12, 10
    U = np.random.default_rng(3).standard_normal((2, nx + 8, ny + 8))
    jd, td = _containers(nx, ny, U)
    dt = 0.05
    jrk = jint.RKIntegrator(jd.t, dt, method=method)
    trk = tint.RKIntegrator(td.t, dt, method=method)
    jrk.set_start(jd)
    trk.set_start(td)
    assert trk.nstages() == jrk.nstages()
    for s in range(trk.nstages()):
        jy = jrk.get_stage_start(s)
        ty = trk.get_stage_start(s)
        assert ty.t == pytest.approx(jy.t, rel=0, abs=1e-15)
        assert ty.t == pytest.approx(0.3 + tint.c[method][s] * dt,
                                     rel=0, abs=1e-15)
        _close(jy.data, ty.data)
        if s > 0:
            assert ty is not td and ty.data.data_ptr() != td.data.data_ptr()
        jrk.store_increment(s, jnp.asarray(_rhs(np.asarray(jy.data), jy.t)))
        trk.store_increment(s, torch.as_tensor(_rhs(ty.data.numpy(), ty.t)))
    # stage starts never wrote into the start's state
    assert np.array_equal(td.data.numpy(), U)
    jrk.compute_final_update()
    out = trk.compute_final_update()
    assert out is td
    _close(jd.data, td.data)
    # only the valid region is accumulated
    g = td.grid
    ghosts = np.ones(U.shape[1:], bool)
    ghosts[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = False
    assert np.array_equal(td.data.numpy()[:, ghosts], U[:, ghosts])
