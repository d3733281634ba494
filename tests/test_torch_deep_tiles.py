"""The tile schedule of the sharded multigrid's deep smoothing kernel
(mg_deep.cu k_deep), run in plain PyTorch on the CPU: for each sub-round and
each tile of a plan, a box of the tile's cells and a halo is built from the
deep frame (clipped to the frame, or wrapped around an unsplit periodic
axis), the sweeps run on it -- a cell updated when it is eligible by its
frame index and its neighbours are still exact in the box, a refreshed
ghost read as its mirror (sign times its source cell) -- and the tile's
cells are written, each refreshed ghost as its sign times its source cell,
with the emit (the restricted residual of the tile's coarse cells, or the
residual of its owned cells).  The frame and the emit must equal
`sharded_mg_kernel.deep_smooth_plain` bit for bit; a halo one cell short
must not reach."""

import numpy as np
import pytest
import torch

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.multigrid import mg_kernel
from pyro2_tpu_torch.multigrid import sharded_mg_kernel as smk
from pyro2_tpu_torch.parallel.sharded_mg import kernel_flags


def _shift(a, di, dj, fill):
    """b[r, s] = a[r + di, s + dj] (fill where that leaves the box)."""
    b = torch.full_like(a, fill)
    R, S = a.shape
    b[max(0, -di):R - max(0, di), max(0, -dj):S - max(0, dj)] = \
        a[max(0, di):R - max(0, -di), max(0, dj):S - max(0, -dj)]
    return b


def _operator(ab, c, dx, dy):
    """(Gauss-Seidel update, residual) from a cell's neighbours, in
    sharded_mg_kernel._operator's order; c the coefficients gathered at
    each cell (ex1: the x plane one row up, ey1: the y plane one column
    up)."""
    if not c:
        alpha, beta = (float(v) for v in ab)
        xc, yc = beta / dx ** 2, beta / dy ** 2
        denom = alpha + 2.0 * xc + 2.0 * yc

        def update(f, xp, xm, yp, ym):
            return (f + xc * (xp + xm) + yc * (yp + ym)) / denom

        def residual(f, v, xp, xm, yp, ym):
            lap = ((xm + xp - 2.0 * v) / dx ** 2 +
                   (ym + yp - 2.0 * v) / dy ** 2)
            return f - alpha * v + beta * lap

        return update, residual
    if "al" not in c:
        denom = c["ex1"] + c["ex"] + c["ey1"] + c["ey"]

        def update(f, xp, xm, yp, ym):
            return (-f + c["ex1"] * xp + c["ex"] * xm + c["ey1"] * yp +
                    c["ey"] * ym) / denom

        def residual(f, v, xp, xm, yp, ym):
            return f - (c["ex1"] * (xp - v) - c["ex"] * (v - xm) +
                        c["ey1"] * (yp - v) - c["ey"] * (v - ym))

        return update, residual
    denom = c["al"] - c["ex1"] - c["ex"] - c["ey1"] - c["ey"]

    def update(f, xp, xm, yp, ym):
        return (f - (c["ex1"] + c["gx"]) * xp - (c["ex"] - c["gx"]) * xm -
                (c["ey1"] + c["gy"]) * yp - (c["ey"] - c["gy"]) * ym) / denom

    def residual(f, v, xp, xm, yp, ym):
        return f - (c["al"] * v + c["ex1"] * (xp - v) - c["ex"] * (v - xm) +
                    c["ey1"] * (yp - v) - c["ey"] * (v - ym) +
                    c["gx"] * (xp - xm) + c["gy"] * (yp - ym))

    return update, residual


class _Axis:
    """One axis of a tile's box: the extended indices it holds, the frame
    index each stands for, and the one whose neighbour below / above is a
    mirror ghost (None: none)."""

    def __init__(self, o0, o1, halo, dp, b, F, wrap, on, src):
        if wrap:
            self.e = torch.arange(o0 - halo, o1 + halo)
            self.frame = (self.e - 1) % b + 1
            self.mlo = self.mhi = None
        else:
            self.e = torch.arange(max(0, o0 - halo), min(F, o1 + halo))
            self.frame = self.e
            self.mlo = src[0] if on[0] else None
            self.mhi = src[1] if on[1] else None
        self.o0, self.o1 = o0, o1

    def at(self, e):
        return int(e) - int(self.e[0])


def deep_schedule(vd, fd, flags, *, dpx, dpy, d, n_sweeps, dx, dy, bc, px,
                  py, ab=None, planes=None, emit="v", smoother="rbgs",
                  tile=None, iters=None, halo_short=0):
    """k_deep's result computed tile by tile and sub-round by sub-round as
    the kernel computes it, with the shipped plan's tile and sub-rounds
    unless `tile` and `iters` (the sweeps of a full sub-round) are given;
    `halo_short` takes cells off the halo."""
    dtype = vd.dtype
    Fx, Fy = vd.shape
    bx, by = Fx - 2 * dpx, Fy - 2 * dpy
    edges = smk.edge_plan(bc, px, py)
    wrap = (edges[0] == 2, edges[2] == 2)
    plan = smk.deep_plan(bx, by, dpx, dpy, n_sweeps, smoother, dtype, wrap)
    tile = tile or plan.tx
    iters = plan.iters if iters is None else iters
    rounds = ([min(iters, n_sweeps - k * iters)
               for k in range(-(-n_sweeps // iters))] if n_sweeps else [0])
    halo = smk.REACH[smoother] * iters + 1 - halo_short
    kinds = (bc.xlb, bc.xrb, bc.ylb, bc.yrb)
    seam = [int(f) != 0 for f in flags[:4]]
    on = [edges[e] == 2 or (edges[e] == 1 and int(flags[4 + e]) != 0)
          for e in range(4)]
    dp, blk = (dpx, dpy), (bx, by)
    ghost = [dp[e // 2] + blk[e // 2] if e % 2 else dp[e // 2] - 1
             for e in range(4)]
    src = [(1 if e % 2 else blk[e // 2]) if kinds[e] == "periodic" else
           (dp[e // 2] + blk[e // 2] - 1 if e % 2 else dp[e // 2])
           for e in range(4)]
    sgn = [-1.0 if mg_kernel.BC_KIND[k] == 1 else 1.0 for k in kinds]
    T = np.float32 if dtype == torch.float32 else np.float64
    nl = (smk._halo_tiles(dpx, tile, halo), smk._halo_tiles(dpy, tile, halo))
    grid = (-(-bx // tile) + 2 * nl[0], -(-by // tile) + 2 * nl[1])
    nb = (grid[0] - 2 * nl[0], grid[1] - 2 * nl[1])
    ncx, ncy = bx // 2, by // 2

    def elig_rows(fr, dpa, b, s_lo, s_hi, lim, wrap_a):
        if wrap_a:
            return torch.ones_like(fr, dtype=torch.bool)
        return (fr >= dpa - (lim if s_lo else 0)) & \
            (fr <= dpa + b - 1 + (lim if s_hi else 0))

    cur, dk_frame = vd, None
    ex_out = None
    for k, n_r in enumerate(rounds):
        s0 = k * iters
        last = k == len(rounds) - 1
        new = torch.full_like(vd, float("nan"))
        dk_new = torch.full_like(vd, float("nan"))
        if last and emit == "v_fc":
            ex_out = torch.full((ncx + 2, ncy + 2), float("nan"), dtype=dtype)
        elif last and emit == "v_r":
            ex_out = torch.full_like(vd, float("nan"))
        for ti in range(grid[0]):
            for tj in range(grid[1]):
                ax = _Axis(*smk._owned(ti, grid[0], tile, dpx, bx, halo),
                           halo, dpx, bx, Fx, wrap[0], on[0:2], src[0:2])
                ay = _Axis(*smk._owned(tj, grid[1], tile, dpy, by, halo),
                           halo, dpy, by, Fy, wrap[1], on[2:4], src[2:4])
                I, J = ax.frame[:, None], ay.frame[None, :]
                Ei, Ej = ax.e[:, None], ay.e[None, :]
                B, Fb = cur[I, J], fd[I, J]
                c = {}
                if planes is not None:
                    Ip = (I + 1).clamp(max=Fx - 1)
                    Jp = (J + 1).clamp(max=Fy - 1)
                    names = ("ex", "ey") if planes.shape[0] == 2 else \
                        ("al", "ex", "ey", "gx", "gy")
                    for n, name in enumerate(names):
                        c[name] = planes[n][I, J]
                    c["ex1"] = planes[names.index("ex")][Ip, J]
                    c["ey1"] = planes[names.index("ey")][I, Jp]
                update, residual = _operator(ab, c, dx, dy)
                mir = [(ax.mlo, 0, Ei), (ax.mhi, 1, Ei), (ay.mlo, 2, Ej),
                       (ay.mhi, 3, Ej)]
                steps = ((1, 0), (-1, 0), (0, 1), (0, -1))

                def nbrs(V, fill):
                    out = []
                    for (m, e, E), (di, dj) in zip(
                            (mir[1], mir[0], mir[3], mir[2]), steps):
                        sh = _shift(V, di, dj, fill)
                        out.append(sh if m is None else
                                   torch.where(E == m, (sgn[e] * V)
                                               if V.dtype != torch.bool
                                               else V, sh))
                    return out           # xp, xm, yp, ym

                def nbrs_exact(X):
                    xp, xm, yp, ym = nbrs(X, False)
                    return xp & xm & yp & ym

                red = ((I - dpx) + (J - dpy)) % 2 == 0

                def elig(lim):
                    if lim < 0 and any(seam):
                        return torch.zeros_like(B, dtype=torch.bool)
                    return elig_rows(I, dpx, bx, seam[0], seam[1], lim,
                                     wrap[0]) & \
                        elig_rows(J, dpy, by, seam[2], seam[3], lim, wrap[1])

                exact = torch.ones_like(B, dtype=torch.bool)
                if smoother == "rbgs":
                    for s in range(s0, s0 + n_r):
                        lim = d - (2 * s + 1)
                        for colour in (red, ~red):
                            upd = elig(lim) & colour
                            can = upd & nbrs_exact(exact)
                            B = torch.where(can, update(Fb, *nbrs(B, 0.0)), B)
                            exact = exact & (~upd | can)
                            lim -= 1
                else:
                    theta, delta = T(1.25), T(0.75)
                    sigma = theta / delta
                    rho = T(1.0) / sigma
                    for s in range(1, s0):
                        rho = T(1.0) / (T(2.0) * sigma - rho)
                    dk = dk_frame[I, J] if s0 > 0 else None
                    for s in range(s0, s0 + n_r):
                        upd = elig(d - (s + 1))
                        can = upd & nbrs_exact(exact)
                        gs = update(Fb, *nbrs(B, 0.0))
                        if smoother == "jacobi":
                            B = torch.where(can, B + 0.8 * (gs - B), B)
                        else:
                            z = torch.where(can, gs - B, 0.0)
                            if s == 0:
                                dk = z / float(theta)
                            else:
                                rho_new = T(1.0) / (T(2.0) * sigma - rho)
                                dk = (float(rho_new * rho) * dk +
                                      float(T(2.0) * rho_new / delta) * z)
                                rho = rho_new
                            B = torch.where(can, B + dk, B)
                        exact = exact & (~upd | can)

                # the tile's cells and the ring around them must be exact
                ri = slice(max(0, ax.at(ax.o0) - 1),
                           ax.at(ax.o1) + 1)
                rj = slice(max(0, ay.at(ay.o0) - 1),
                           ay.at(ay.o1) + 1)
                assert bool(exact[ri, rj].all()), "the halo does not reach"

                # the write-out: a refreshed ghost its sign times its source
                rows = torch.arange(ax.o0, ax.o1)
                cols = torch.arange(ay.o0, ay.o1)
                sr, sc = rows.clone(), cols.clone()
                fx = torch.ones(len(rows), dtype=dtype)
                fy = torch.ones(len(cols), dtype=dtype)
                for e, (r, sv, fv, w_) in enumerate(
                        ((rows, sr, fx, wrap[0]), (rows, sr, fx, wrap[0]),
                         (cols, sc, fy, wrap[1]), (cols, sc, fy, wrap[1]))):
                    if on[e] and not w_:
                        hit = r == ghost[e]
                        sv[hit] = src[e]
                        fv[hit] = sgn[e]
                vals = B[sr - int(ax.e[0])][:, sc - int(ay.e[0])]
                vals = torch.where((fx != 1.0)[:, None], fx[:, None] * vals,
                                   vals)
                vals = torch.where((fy != 1.0)[None, :], fy[None, :] * vals,
                                   vals)
                new[ax.o0:ax.o1, ay.o0:ay.o1] = vals
                if smoother == "chebyshev" and not last:
                    dk_new[ax.o0:ax.o1, ay.o0:ay.o1] = \
                        dk[ax.at(ax.o0):ax.at(ax.o1),
                           ay.at(ay.o0):ay.at(ay.o1)]
                if not last or emit == "v":
                    continue
                r = residual(Fb, B, *nbrs(B, float("nan")))
                if emit == "v_r":
                    own = ((rows >= dpx) & (rows < dpx + bx))[:, None] & \
                        ((cols >= dpy) & (cols < dpy + by))[None, :]
                    ex_out[ax.o0:ax.o1, ay.o0:ay.o1] = torch.where(
                        own, r[ax.at(ax.o0):ax.at(ax.o1),
                               ay.at(ay.o0):ay.at(ay.o1)], 0.0)
                    continue
                mx, my = ti - nl[0], tj - nl[1]
                if not (0 <= mx < nb[0] and 0 <= my < nb[1]):
                    continue                # a tile of the halo
                I0, J0 = 1 + mx * tile // 2, 1 + my * tile // 2
                R0 = 0 if mx == 0 else I0
                R1 = ncx + 2 if mx == nb[0] - 1 else I0 + tile // 2
                C0 = 0 if my == 0 else J0
                C1 = ncy + 2 if my == nb[1] - 1 else J0 + tile // 2
                for Ic in range(R0, R1):
                    for Jc in range(C0, C1):
                        if not (1 <= Ic <= ncx and 1 <= Jc <= ncy):
                            ex_out[Ic, Jc] = 0.0
                            continue
                        i = ax.at(dpx + 2 * Ic - 2)
                        j = ay.at(dpy + 2 * Jc - 2)
                        ex_out[Ic, Jc] = 0.25 * (((r[i, j] + r[i + 1, j]) +
                                                  r[i, j + 1]) +
                                                 r[i + 1, j + 1])
        cur, dk_frame = new, dk_new
    return cur, ex_out


def _bits(a, b):
    it = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(a.contiguous().view(it), b.contiguous().view(it))


# the smoothers' sweeps and depth: as sharded_mg schedules a round (d - 1
# halo cells a round: 2 a red-black sweep, 1 a Jacobi / Chebyshev step)
SWEEPS = {"rbgs": (3, 7), "jacobi": (4, 5), "chebyshev": (4, 5)}
EDGES = ("dirichlet", "neumann", "periodic")


def _frames(n, px, py, ix, iy, d, dtype, rng, ncoef=0):
    bx, by = n // px, n // py
    dpx, dpy = (d if px > 1 else 1), (d if py > 1 else 1)
    shape = (bx + 2 * dpx, by + 2 * dpy)
    vd = torch.as_tensor(0.1 * rng.standard_normal(shape), dtype=dtype)
    fd = torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    planes = None
    if ncoef == 2:
        planes = torch.as_tensor(1.0 + rng.random((2,) + shape), dtype=dtype)
    elif ncoef == 5:
        a = rng.standard_normal((5,) + shape)
        a[0] -= 10.0
        a[1:3] = 1.0 + rng.random((2,) + shape)
        a[3:] *= 0.1
        planes = torch.as_tensor(a, dtype=dtype)
    return vd, fd, planes, dpx, dpy


def _check(vd, fd, flags, **kw):
    ref = smk.deep_smooth_plain(vd, fd, flags,
                                **{k: v for k, v in kw.items()
                                   if k not in ("tile", "iters")})
    got = deep_schedule(vd, fd, flags, **kw)
    assert _bits(got[0], ref[0])
    assert (ref[1] is None) == (got[1] is None)
    if ref[1] is not None:
        assert _bits(got[1], ref[1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ncoef", [0, 2, 5])
@pytest.mark.parametrize("smoother", smk.SMOOTHERS)
def test_smoothers_and_operators(smoother, ncoef, dtype):
    """Each smoother with each operator, on one block of a 2x2 split of
    16^2 (Dirichlet edges) in 2^2-cell tiles, and on the 1x1 frame
    (Neumann) with the shipped plan, every emit."""
    rng = np.random.default_rng(11 + ncoef)
    n_sw, d = SWEEPS[smoother]
    for (px, py, ix, iy, edge, tile), emit in zip(
            ((2, 2, 1, 0, "dirichlet", 2), (1, 1, 0, 0, "neumann", None),
             (2, 2, 0, 1, "periodic", 4)), smk.EMITS):
        bc = bnd.BC(xlb=edge, xrb=edge, ylb=edge, yrb=edge)
        vd, fd, planes, dpx, dpy = _frames(16, px, py, ix, iy, d, dtype, rng,
                                           ncoef)
        kw = dict(dpx=dpx, dpy=dpy, d=d, n_sweeps=n_sw, dx=1 / 16,
                  dy=1 / 16, bc=bc, px=px, py=py, emit=emit,
                  smoother=smoother, tile=tile)
        if ncoef:
            kw["planes"] = planes
        else:
            kw["ab"] = (1.0, 0.3 / 16 ** 2)
        _check(vd, fd, kernel_flags(bc, px, py, ix, iy), **kw)


@pytest.mark.parametrize("edge", EDGES)
@pytest.mark.parametrize("split", [(1, 1), (2, 2), (1, 4)])
def test_every_block_of_a_split(split, edge):
    """Every block of a 1x1, 2x2 and 1x4 split of 32^2, red-black with the
    constant operator, the emits v_fc and v_r, in 6^2-cell tiles (the last
    ragged) and with the shipped plan."""
    px, py = split
    rng = np.random.default_rng(px * 10 + py)
    bc = bnd.BC(xlb=edge, xrb=edge, ylb=edge, yrb=edge)
    for ix in range(px):
        for iy in range(py):
            for tile, emit in ((6, "v_fc"), (None, "v_r")):
                vd, fd, _, dpx, dpy = _frames(32, px, py, ix, iy, 7,
                                              torch.float64, rng)
                _check(vd, fd, kernel_flags(bc, px, py, ix, iy), dpx=dpx,
                       dpy=dpy, d=7, n_sweeps=3, dx=1 / 32, dy=1 / 32, bc=bc,
                       px=px, py=py, ab=(1.0, 0.3 / 32 ** 2), emit=emit,
                       tile=tile)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("smoother", smk.SMOOTHERS)
def test_sub_rounds(smoother, dtype):
    """A round split into sub-rounds (2 + 2 + 1 sweeps), each carrying its
    first sweep's index, on the periodic 1x1 frame (whose boxes wrap) and
    on a block of a 2x2 Dirichlet split with a depth the sweeps outrun (a
    seam side takes no cell once lim < 0)."""
    rng = np.random.default_rng(5)
    for px, edge, d in ((1, "periodic", 21), (2, "dirichlet", 7)):
        bc = bnd.BC(xlb=edge, xrb=edge, ylb=edge, yrb=edge)
        vd, fd, _, dpx, dpy = _frames(16, px, px, px - 1, 0, d, dtype, rng)
        _check(vd, fd, kernel_flags(bc, px, px, px - 1, 0), dpx=dpx,
               dpy=dpy, d=d, n_sweeps=5, dx=1 / 16, dy=1 / 16, bc=bc, px=px,
               py=px, ab=(1.0, -1.0), emit="v_fc", smoother=smoother, tile=4,
               iters=2)


def test_the_shipped_plan_splits_long_rounds():
    """At 50 sweeps the plan of the 1x1 1024^2 frame splits the round into
    sub-rounds of at most its halo's sweeps; the schedule with the plan's
    split on a 16^2 frame gives the plain version's bits."""
    plan = smk.deep_plan(1024, 1024, 1, 1, 50, "rbgs", torch.float32)
    assert plan.rounds > 1 and sum(plan.round_iters()) == 50
    rng = np.random.default_rng(9)
    bc = bnd.BC(xlb="neumann", xrb="neumann", ylb="neumann", yrb="neumann")
    vd, fd, _, dpx, dpy = _frames(16, 1, 1, 0, 0, 21, torch.float64, rng)
    _check(vd, fd, kernel_flags(bc, 1, 1, 0, 0), dpx=1, dpy=1, d=21,
           n_sweeps=50, dx=1 / 16, dy=1 / 16, bc=bc, px=1, py=1,
           ab=(1.0, 0.3 / 16 ** 2), emit="v_r", tile=4,
           iters=plan.iters)


@pytest.mark.parametrize("smoother", ["rbgs", "chebyshev"])
def test_a_halo_one_cell_short_does_not_reach(smoother):
    """A halo of the sweeps' reach alone (one cell short of the residual's
    ring) leaves a cell the emit reads stale: the schedule sees it."""
    rng = np.random.default_rng(4)
    bc = bnd.BC(xlb="dirichlet", xrb="dirichlet", ylb="dirichlet",
                yrb="dirichlet")
    n_sw, d = SWEEPS[smoother]
    vd, fd, _, dpx, dpy = _frames(32, 2, 2, 0, 1, d, torch.float64, rng)
    kw = dict(dpx=dpx, dpy=dpy, d=d, n_sweeps=n_sw, dx=1 / 32, dy=1 / 32,
              bc=bc, px=2, py=2, ab=(1.0, 0.01), emit="v_fc",
              smoother=smoother, tile=4)
    flags = kernel_flags(bc, 2, 2, 0, 1)
    deep_schedule(vd, fd, flags, **kw)
    with pytest.raises(AssertionError, match="the halo does not reach"):
        deep_schedule(vd, fd, flags, halo_short=1, **kw)
