"""The tile schedule of the lm_atm interface kernels
(pyro2_tpu_torch/csrc/lm_interface.cu), run in torch on the CPU.

Each tile of lm_kernel.plan is computed only from its boxes, as a block of
k_lm_mac, k_lm_rho or k_lm_states computes it: the input planes over the
tile and its halo (zero beyond the frame), the first-pass values over the
tile and its ring, and for rho and the states the final face values of
the tile's x and y faces; every window is a test of the global index.
The assembled outputs are held bit for bit against the plain versions
(mac_vels_plain, rho_increment_plain, advect_terms_plain) in float64 and
float32, on grids that are not tile multiples and span several tiles
each way, with random signed fields with exact ties (zeros) put in; every
output cell is written by exactly one tile.  A box read outside its
extent raises, so a halo one cell short fails.

The arithmetic is the plain versions' (a division by dx where the kernels
multiply by 1/dx, as PyTorch does on CUDA): what is held here is the
schedule -- which cells each phase computes, from which box -- and
chip_smoke.py holds the CUDA arithmetic against the plain versions on the
card.
"""

import numpy as np
import pytest
import torch

from pyro2_tpu_torch.mesh.grid import Cartesian2d
from pyro2_tpu_torch.solvers.lm_atm import lm_kernel

DTYPES = [torch.float64, torch.float32]
# the input planes in their entries' order
U, V, LUX, LVX, LUY, LVY, GPX, GPY, SRC, UMAC, VMAC = range(11)
RHO, RUM, RVM, LRX, LRY = range(5)


# -- boxes --------------------------------------------------------------------

class _Box:
    """Planes over the frame cells [i0, i0 + h) x [j0, j0 + w)."""

    def __init__(self, t, i0, j0):
        self.t, self.i0, self.j0 = t, i0, j0
        self.h, self.w = t.shape[-2:]

    def get(self, n, r):
        """Plane n over the region r = (a0, a1, b0, b1) of frame cells."""
        a0, a1, b0, b1 = r
        if (a0 < self.i0 or b0 < self.j0 or a1 > self.i0 + self.h or
                b1 > self.j0 + self.w):
            raise IndexError(f"a read of rows [{a0}, {a1}), columns "
                             f"[{b0}, {b1}) outside the box")
        return self.t[n, a0 - self.i0:a1 - self.i0, b0 - self.j0:b1 - self.j0]


def _load(frames, i0, j0, h, w):
    """The box of the (n, qx, qy) planes at (i0, j0), h x w cells, zero
    beyond the frame."""
    _, qx, qy = frames.shape
    out = frames.new_zeros((frames.shape[0], h, w))
    a0, a1, b0, b1 = max(i0, 0), min(i0 + h, qx), max(j0, 0), min(j0 + w, qy)
    if a0 < a1 and b0 < b1:
        out[:, a0 - i0:a1 - i0, b0 - j0:b1 - j0] = frames[:, a0:a1, b0:b1]
    return _Box(out, i0, j0)


def _sh(r, di, dj):
    return (r[0] + di, r[1] + di, r[2] + dj, r[3] + dj)


def _win(g, r, lo_x, hi_x, lo_y, hi_y):
    """The cells of region r inside the window [ilo - lo_x, ihi + hi_x] x
    [jlo - lo_y, jhi + hi_y], by global index."""
    i = torch.arange(r[0], r[1])[:, None]
    j = torch.arange(r[2], r[3])[None, :]
    ilo, ihi, jlo, jhi = g.ng, g.ng + g.nx - 1, g.ng, g.ng + g.ny - 1
    return ((i >= ilo - lo_x) & (i <= ihi + hi_x) & (j >= jlo - lo_y) &
            (j <= jhi + hi_y))


def _w2(g, r):
    return _win(g, r, 2, 2, 2, 2)


def _w1(g, r):
    return _win(g, r, 1, 1, 1, 1)


def _w12(g, r):
    return _win(g, r, 1, 2, 1, 2)


# -- the plain expressions, cell by cell --------------------------------------

def _riemann(ql, qr):
    return torch.where((ql > 0.0) & (ql + qr > 0.0), ql,
                       torch.where((ql <= 0.0) & (qr >= 0.0), 0.0, qr))


def _upwind(ql, qr, s):
    return torch.where(s > 0.0, ql,
                       torch.where(s == 0.0, 0.5 * (ql + qr), qr))


def _hats(g, dt, a, r):
    """The eight hat states of the velocity stages over region r, zero
    where the predicting cell lies outside the buf=2 window."""
    dtdx, dtdy = dt / g.dx, dt / g.dy
    xm, ym = _sh(r, -1, 0), _sh(r, 0, -1)
    z = a.get(U, r).new_zeros(())
    u_xm, v_ym, u0, v0 = a.get(U, xm), a.get(V, ym), a.get(U, r), a.get(V, r)
    mx, my, m0 = _w2(g, xm), _w2(g, ym), _w2(g, r)
    return {
        "u_xl": torch.where(mx, u_xm + 0.5 * (1.0 - dtdx * u_xm) *
                            a.get(LUX, xm), z),
        "v_xl": torch.where(mx, a.get(V, xm) + 0.5 * (1.0 - dtdx * u_xm) *
                            a.get(LVX, xm), z),
        "u_yl": torch.where(my, a.get(U, ym) + 0.5 * (1.0 - dtdy * v_ym) *
                            a.get(LUY, ym), z),
        "v_yl": torch.where(my, v_ym + 0.5 * (1.0 - dtdy * v_ym) *
                            a.get(LVY, ym), z),
        "u_xr": torch.where(m0, u0 - 0.5 * (1.0 + dtdx * u0) *
                            a.get(LUX, r), z),
        "v_xr": torch.where(m0, v0 - 0.5 * (1.0 + dtdx * u0) *
                            a.get(LVX, r), z),
        "u_yr": torch.where(m0, u0 - 0.5 * (1.0 + dtdy * v0) *
                            a.get(LUY, r), z),
        "v_yr": torch.where(m0, v0 - 0.5 * (1.0 + dtdy * v0) *
                            a.get(LVY, r), z),
    }


def _first_vel(g, dt, a, r):
    """uhat, vhat, uxi, vxi, uyi, vyi over region r (zero outside the
    (lo-1, hi+2) window), stacked."""
    h = _hats(g, dt, a, r)
    uhat = _riemann(h["u_xl"], h["u_xr"])
    vhat = _riemann(h["v_yl"], h["v_yr"])
    out = torch.stack([uhat, vhat, _upwind(h["u_xl"], h["u_xr"], uhat),
                       _upwind(h["v_xl"], h["v_xr"], uhat),
                       _upwind(h["u_yl"], h["u_yr"], vhat),
                       _upwind(h["v_yl"], h["v_yr"], vhat)])
    return torch.where(_w12(g, r), out, out.new_zeros(()))


UHAT, VHAT, UXI, VXI, UYI, VYI = range(6)


def _corr(g, dt, a, s, r, name):
    """One of the corrections du_x, dv_x, dv_y, du_y over region r, zero
    outside the buf=1 window."""
    dtdx, dtdy = dt / g.dx, dt / g.dy
    z = a.get(U, r).new_zeros(())
    if name in ("du_x", "dv_x"):
        bar = 0.5 * (s.get(VHAT, r) + s.get(VHAT, _sh(r, 0, 1)))
        n = UYI if name == "du_x" else VYI
        d = bar * (s.get(n, _sh(r, 0, 1)) - s.get(n, r))
        c = -0.5 * dtdy * d
    else:
        bar = 0.5 * (s.get(UHAT, r) + s.get(UHAT, _sh(r, 1, 0)))
        n = VXI if name == "dv_y" else UXI
        d = bar * (s.get(n, _sh(r, 1, 0)) - s.get(n, r))
        c = -0.5 * dtdx * d
    if name in ("du_x", "du_y"):
        val = c - 0.5 * dt * a.get(GPX, r)
    else:
        val = c - 0.5 * dt * a.get(GPY, r) + 0.5 * dt * a.get(SRC, r)
    return torch.where(_w1(g, r), val, z)


def _first_rho(g, dt, a, r):
    """rho's hat states over region r, each pair upwinded by the MAC
    velocity of its face: (xl, xr, yl, yr), and the upwinded rxi, ryi
    (zero outside the (lo-1, hi+2) window)."""
    dtdx, dtdy = dt / g.dx, dt / g.dy
    xm, ym = _sh(r, -1, 0), _sh(r, 0, -1)
    z = a.get(RHO, r).new_zeros(())
    um, vm, rho = a.get(RUM, r), a.get(RVM, r), a.get(RHO, r)
    xl = torch.where(_w2(g, xm), a.get(RHO, xm) + 0.5 * (1.0 - dtdx * um) *
                     a.get(LRX, xm), z)
    yl = torch.where(_w2(g, ym), a.get(RHO, ym) + 0.5 * (1.0 - dtdy * vm) *
                     a.get(LRY, ym), z)
    m0 = _w2(g, r)
    xr = torch.where(m0, rho - 0.5 * (1.0 + dtdx * um) * a.get(LRX, r), z)
    yr = torch.where(m0, rho - 0.5 * (1.0 + dtdy * vm) * a.get(LRY, r), z)
    w = _w12(g, r)
    return (xl, xr, yl, yr), torch.stack([
        torch.where(w, _upwind(xl, xr, um), z),
        torch.where(w, _upwind(yl, yr, vm), z)])


def _rho_corr(g, dt, a, s, r, name):
    """dx_corr or dy_corr over region r, zero outside the buf=2 window."""
    z = a.get(RHO, r).new_zeros(())
    um, vm, rho = a.get(RUM, r), a.get(RVM, r), a.get(RHO, r)
    um1, vm1 = a.get(RUM, _sh(r, 1, 0)), a.get(RVM, _sh(r, 0, 1))
    if name == "dx":
        u_x = (um1 - um) / g.dx
        rhov_y = (s.get(1, _sh(r, 0, 1)) * vm1 - s.get(1, r) * vm) / g.dy
        val = -0.5 * dt * (rhov_y + rho * u_x)
    else:
        v_y = (vm1 - vm) / g.dy
        rhou_x = (s.get(0, _sh(r, 1, 0)) * um1 - s.get(0, r) * um) / g.dx
        val = -0.5 * dt * (rhou_x + rho * v_y)
    return torch.where(_w2(g, r), val, z)


# -- the schedule -------------------------------------------------------------

def run_tiles(entry, g, dt, planes, plan):
    """The outputs of `entry` assembled from every tile of `plan`, each
    computed from its boxes only; every output cell written once."""
    frames = torch.stack(list(planes))
    tx, ty, lo, hi = plan.tx, plan.ty, plan.lo, plan.hi
    mac = entry == "lm_mac"
    rows, cols = (g.qx, g.qy) if mac else (g.nx, g.ny)
    origin = 0 if mac else g.ng
    outs = [frames.new_full((rows, cols), float("nan"))
            for _ in range(1 if entry == "lm_rho" else 2)]
    written = torch.zeros((rows, cols), dtype=torch.int64)
    for by in range(plan.gy):
        for bx in range(plan.gx):
            I0, J0 = origin + by * tx, origin + bx * ty
            a = _load(frames, I0 - lo, J0 - lo, tx + lo + hi, ty + lo + hi)
            ring = (I0 - 1, I0 + tx + 1, J0 - 1, J0 + ty + 1)
            tile = (I0, min(I0 + tx, origin + rows), J0,
                    min(J0 + ty, origin + cols))
            if entry == "lm_rho":
                _, fp = _first_rho(g, dt, a, ring)
            else:
                fp = _first_vel(g, dt, a, ring)
            s = _Box(fp, I0 - 1, J0 - 1)
            if mac:
                got = _mac_tile(g, dt, a, s, tile)
            elif entry == "lm_rho":
                got = _rho_tile(g, dt, a, s, I0, J0, tx, ty, tile)
            else:
                got = _states_tile(g, dt, a, s, I0, J0, tx, ty, tile)
            o = (tile[0] - origin, tile[1] - origin, tile[2] - origin,
                 tile[3] - origin)
            for out, val in zip(outs, got):
                out[o[0]:o[1], o[2]:o[3]] = val
            written[o[0]:o[1], o[2]:o[3]] += 1
    assert bool((written == 1).all())
    return outs


def _mac_tile(g, dt, a, s, t):
    h = _hats(g, dt, a, t)
    uxl = h["u_xl"] + _corr(g, dt, a, s, _sh(t, -1, 0), "du_x")
    uxr = h["u_xr"] + _corr(g, dt, a, s, t, "du_x")
    vyl = h["v_yl"] + _corr(g, dt, a, s, _sh(t, 0, -1), "dv_y")
    vyr = h["v_yr"] + _corr(g, dt, a, s, t, "dv_y")
    w = _w12(g, t)
    z = uxl.new_zeros(())
    return (torch.where(w, _upwind(uxl, uxr, _riemann(uxl, uxr)), z),
            torch.where(w, _upwind(vyl, vyr, _riemann(vyl, vyr)), z))


def _states_tile(g, dt, a, s, I0, J0, tx, ty, t):
    # the final states of the tile's x faces (rows I0 .. I0 + tx) and y
    # faces (columns J0 .. J0 + ty), from the boxes
    xr_ = (I0, I0 + tx + 1, J0, J0 + ty)
    yr_ = (I0, I0 + tx, J0, J0 + ty + 1)
    hx, hy = _hats(g, dt, a, xr_), _hats(g, dt, a, yr_)
    z = hx["u_xl"].new_zeros(())
    wx, wy = _w12(g, xr_), _w12(g, yr_)
    um = torch.where(wx, a.get(UMAC, xr_), z)
    vm = torch.where(wy, a.get(VMAC, yr_), z)
    xl = _sh(xr_, -1, 0)
    fx = torch.stack([
        torch.where(wx, _upwind(hx["u_xl"] + _corr(g, dt, a, s, xl, "du_x"),
                                hx["u_xr"] + _corr(g, dt, a, s, xr_, "du_x"),
                                um), z),
        torch.where(wx, _upwind(hx["v_xl"] + _corr(g, dt, a, s, xl, "dv_x"),
                                hx["v_xr"] + _corr(g, dt, a, s, xr_, "dv_x"),
                                um), z)])
    yl = _sh(yr_, 0, -1)
    fy = torch.stack([
        torch.where(wy, _upwind(hy["u_yl"] + _corr(g, dt, a, s, yl, "du_y"),
                                hy["u_yr"] + _corr(g, dt, a, s, yr_, "du_y"),
                                vm), z),
        torch.where(wy, _upwind(hy["v_yl"] + _corr(g, dt, a, s, yl, "dv_y"),
                                hy["v_yr"] + _corr(g, dt, a, s, yr_, "dv_y"),
                                vm), z)])
    fx, fy = _Box(fx, I0, J0), _Box(fy, I0, J0)
    # the centred differences of the interior cells
    ubar = 0.5 * (a.get(UMAC, t) + a.get(UMAC, _sh(t, 1, 0)))
    vbar = 0.5 * (a.get(VMAC, t) + a.get(VMAC, _sh(t, 0, 1)))
    return tuple(
        ubar * (fx.get(n, _sh(t, 1, 0)) - fx.get(n, t)) / g.dx +
        vbar * (fy.get(n, _sh(t, 0, 1)) - fy.get(n, t)) / g.dy
        for n in (0, 1))


def _rho_tile(g, dt, a, s, I0, J0, tx, ty, t):
    xr_ = (I0, I0 + tx + 1, J0, J0 + ty)
    yr_ = (I0, I0 + tx, J0, J0 + ty + 1)
    (xl, xr, _, _), _ = _first_rho(g, dt, a, xr_)
    (_, _, yl, yr), _ = _first_rho(g, dt, a, yr_)
    z = xl.new_zeros(())
    xl = xl + _rho_corr(g, dt, a, s, _sh(xr_, -1, 0), "dx")
    xr = xr + _rho_corr(g, dt, a, s, xr_, "dx")
    yl = yl + _rho_corr(g, dt, a, s, _sh(yr_, 0, -1), "dy")
    yr = yr + _rho_corr(g, dt, a, s, yr_, "dy")
    fx = _Box(torch.where(_w12(g, xr_), _upwind(xl, xr, a.get(RUM, xr_)),
                          z)[None], I0, J0)
    fy = _Box(torch.where(_w12(g, yr_), _upwind(yl, yr, a.get(RVM, yr_)),
                          z)[None], I0, J0)
    rx0, rx1 = fx.get(0, t), fx.get(0, _sh(t, 1, 0))
    ry0, ry1 = fy.get(0, t), fy.get(0, _sh(t, 0, 1))
    um0, um1 = a.get(RUM, t), a.get(RUM, _sh(t, 1, 0))
    vm0, vm1 = a.get(RVM, t), a.get(RVM, _sh(t, 0, 1))
    return (-dt * ((rx1 * um1 - rx0 * um0) / g.dx +
                   (ry1 * vm1 - ry0 * vm0) / g.dy),)


# -- fields -------------------------------------------------------------------

def _fields(g, dtype, seed, ties=True):
    """The stages' planes from a seed: u, v, the four velocity slopes,
    gpx, gpy, source, rho and its two slopes, signed at random, with exact
    zeros put in (rows of u, columns of v, opposed neighbours, zero slopes)
    so that the upwind ties (s == 0) and every Riemann branch fire."""
    rng = np.random.default_rng(seed)

    def mk(lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, size=(g.qx, g.qy))

    u, v = mk(), mk()
    planes = [mk() for _ in range(7)]
    rho, lrx, lry = mk(0.5, 1.5), mk(), mk()
    if ties:
        u[::3] = 0.0
        v[:, ::2] = 0.0
        u[:, 5] = -u[:, 6]
        planes[0][1::4] = 0.0
        planes[3][:, 1::3] = 0.0
        lrx[::2] = 0.0
    t = [torch.as_tensor(a, dtype=dtype) for a in [u, v] + planes]
    return t, [torch.as_tensor(a, dtype=dtype) for a in (rho, lrx, lry)]


def _calls(g, dtype, seed):
    """(dt, planes) of each entry; the MAC velocities from the plain
    mac_vels, as the step hands them on."""
    vel, (rho, lrx, lry) = _fields(g, dtype, seed)
    dt = 0.2 * g.dx
    um, vm = lm_kernel.mac_vels_plain(g, dt, *vel)
    return {"lm_mac": (dt, vel),
            "lm_rho": (dt, [rho, um, vm, lrx, lry]),
            "lm_states": (dt, vel + [um, vm])}


PLAIN = {"lm_mac": lm_kernel.mac_vels_plain,
         "lm_rho": lm_kernel.rho_increment_plain,
         "lm_states": lm_kernel.advect_terms_plain}
# ragged grids against every entry's tile (16 x 32, 16 x 64, 8 x 64): one
# tile's worth and less, and several tiles each way with ragged last ones
GRIDS = [(13, 23), (40, 70), (45, 135)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nx,ny", GRIDS)
@pytest.mark.parametrize("entry", lm_kernel.ENTRIES)
def test_tiles_give_the_plain_versions_bits(entry, nx, ny, dtype):
    g = Cartesian2d(nx, ny, ng=4, xmax=1.0, ymax=ny / nx)
    dt, planes = _calls(g, dtype, 7 * nx + ny)[entry]
    plan = lm_kernel.plan(entry, nx, ny, g.ng, dtype)
    ref = PLAIN[entry](g, dt, *planes)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = run_tiles(entry, g, dt, planes, plan)
    for r, o in zip(ref, got):
        assert r.dtype == o.dtype == dtype
        assert torch.equal(r, o)


def test_the_fields_put_ties_in():
    # the upwind ties and each Riemann branch fire on these fields
    g = Cartesian2d(40, 23, ng=4, xmax=1.0, ymax=23 / 40)
    dt, planes = _calls(g, torch.float64, 303)["lm_states"]
    a = _load(torch.stack(planes), 0, 0, g.qx, g.qy)
    r = (1, g.qx - 1, 1, g.qy - 1)
    h = _hats(g, dt, a, r)
    s = _riemann(h["u_xl"], h["u_xr"])
    w = _w12(g, r)
    assert bool((w & (s == 0)).any()) and bool((w & (s > 0)).any())
    assert bool((w & (s < 0)).any())
    assert bool((w & (h["u_xl"] <= 0) & (h["u_xr"] >= 0) &
                 (h["u_xl"] != 0)).any())


@pytest.mark.parametrize("entry", lm_kernel.ENTRIES)
@pytest.mark.parametrize("short", ["lo", "hi"])
def test_a_halo_one_cell_short_reads_outside_its_box(entry, short):
    g = Cartesian2d(40, 70, ng=4, xmax=1.0, ymax=70 / 40)
    dt, planes = _calls(g, torch.float64, 5)[entry]
    plan = lm_kernel.LmPlan(entry, g.nx, g.ny, g.ng, torch.float64)
    run_tiles(entry, g, dt, planes, plan)
    setattr(plan, short, getattr(plan, short) - 1)
    with pytest.raises(IndexError, match="outside the box"):
        run_tiles(entry, g, dt, planes, plan)
