"""The tile schedule of the multigrid ascent kernel (mg_vcycle.cu k_up), run
in plain PyTorch on the CPU: for each tile of a plan, the box of the tile and
its halo is built from the frame (the wrapped interior across a periodic
edge; across any other edge each cell's ghost mirrors the cell itself), the
rounds' half-sweeps of the plain red-black stencil run on it while the cells
that are still exact shrink, and the tile's cells, the ghosts that mirror
them (written as the kernels' `put` writes them) and the residual must
equal `mg_kernel.up_plain` bit for bit.  A halo one cell too shallow, a
wrong colour across a wrapped edge or a mirror with the wrong sign shows
here without a card; so does a ZERO edge (the cavity's moving lid, sign 0,
the constant operator's) whose ghosts come out -0.0.  `make_mg`,
`tile_round`, `put_ghosts` and `same_bits` serve the descent's schedule
too (tests/test_torch_mg_down_tiles.py)."""

import numpy as np
import pytest
import torch

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.mesh.patch import prolong_array
from pyro2_tpu_torch.multigrid import mg_kernel
from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d
from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d
from pyro2_tpu_torch.multigrid.variable_coeff_MG import VarCoeffCCMG2d
from pyro2_tpu_torch.solvers.incompressible_viscous import BC

# the edge sets: x-lo, x-hi, y-lo, y-hi (lm_atm's phi edges, and the
# cavity's velocity edges under the moving lid)
EDGES = {"neumann": ("neumann",) * 4, "periodic": ("periodic",) * 4,
         "dirichlet": ("dirichlet",) * 4,
         "lm_atm": ("periodic", "periodic", "neumann", "dirichlet"),
         "cavity": ("dirichlet", "dirichlet", "dirichlet", "moving_lid")}

# the sign of a ghost by the kernels' kind (mg_kernel.BC_KIND, ZERO)
SIGN = {0: 1.0, 1: -1.0, 2: 1.0, mg_kernel.ZERO: 0.0}


def mirror(sign, a):
    """mg_vcycle.cu's mirror, through which the constant operator's
    kernels write every ghost: sign times a, and +0 for the sign 0 of a
    ZERO edge."""
    return torch.zeros_like(a) if sign == 0.0 else sign * a


def same_bits(a, b):
    """a and b equal bit for bit (+0.0 and -0.0 apart)."""
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.dtype == b.dtype and torch.equal(a.view(ints), b.view(ints))


def put_ghosts(mg, level, a):
    """A copy of frame a whose ghosts are written as the kernels' `put`
    writes them from the interior cells they mirror: x-lo, x-hi, y-lo,
    y-hi, and each corner the y edge's sign times the x edge's times its
    cell (the periodic edges mirroring the cell across the level)."""
    kinds = mg_kernel.edge_kinds(mg.bc_v[level])
    sign = [SIGN[k] for k in kinds]
    q = a.shape[-1]
    src = [q - 2 if kinds[0] == 2 else 1, 1 if kinds[1] == 2 else q - 2,
           q - 2 if kinds[2] == 2 else 1, 1 if kinds[3] == 2 else q - 2]
    out = a.clone()
    inner = slice(1, q - 1)
    out[0, inner] = mirror(sign[0], a[src[0], inner])
    out[q - 1, inner] = mirror(sign[1], a[src[1], inner])
    out[inner, 0] = mirror(sign[2], a[inner, src[2]])
    out[inner, q - 1] = mirror(sign[3], a[inner, src[3]])
    for i, sx, j, sy in ((0, 0, 0, 2), (0, 0, q - 1, 3), (q - 1, 1, 0, 2),
                         (q - 1, 1, q - 1, 3)):
        out[i, j] = mirror(sign[sy], mirror(sign[sx],
                                            a[src[sx], src[sy]]))
    return out


def make_mg(op, n, edge, dtype):
    """An n^2 multigrid object of operator op with one of EDGES on the
    CPU (the moving lid registered as incompressible_viscous registers
    it)."""
    xl, xr, yl, yr = EDGES[edge]
    if "moving_lid" in EDGES[edge]:
        bnd.define_bc("moving_lid", BC.user, is_solid=False)
    kw = dict(xl_BC_type=xl, xr_BC_type=xr, yl_BC_type=yl, yr_BC_type=yr,
              device="cpu", dtype=dtype)
    if op == "const":
        beta = -1.0 if edge == "periodic" else 0.3 / n ** 2
        return CellCenterMG2d(n, n, alpha=1.0, beta=beta, **kw)
    g = Grid2d(n, n, ng=1)
    x, y = g.x2d, g.y2d
    neumann = bnd.BC(xlb="neumann", xrb="neumann", ylb="neumann",
                     yrb="neumann")
    if op == "vc":
        eta = 2.0 + np.cos(2 * np.pi * x) * np.cos(2 * np.pi * y) + 0.3 * x
        return VarCoeffCCMG2d(n, n, coeffs=eta, coeffs_bc=neumann, **kw)
    d = patch.CellCenterData2d(g, dtype=dtype, device="cpu")
    for name in ("alpha", "beta", "gamma_x", "gamma_y"):
        d.register_var(name, neumann)
    d.create()
    for name, a in (("alpha", 10.0 + 0 * x), ("beta", x * y + 1.0),
                    ("gamma_x", 1.0 + 0 * x), ("gamma_y", 1.0 + 0 * y)):
        d.set_var(name, a)
    return GeneralMG2d(n, n, coeffs=d, **kw)


def _coefs(mg, op, level):
    """The frames the plain smoother and residual read, by name."""
    if op == "vc":
        e = mg.edge_coeffs[level]
        return {"ex": e.x, "ey": e.y}
    if op == "general":
        return dict(zip(("al", "ex", "ey", "gx", "gy"), mg.planes[level]))
    return {}


def _gs(mg, op, g, f, xp, xm, yp, ym, c):
    """The plain smoother's update, in its order of operations (MG.py,
    variable_coeff_MG.py, general_MG.py), from the neighbours' values and
    the coefficients gathered at each cell (c["ex1"] the x plane one row
    up, c["ey1"] the y plane one column up)."""
    if op == "const":
        xc, yc = mg.beta / g.dx ** 2, mg.beta / g.dy ** 2
        den = mg.alpha + 2.0 * xc + 2.0 * yc
        return (f + xc * (xp + xm) + yc * (yp + ym)) / den
    if op == "vc":
        den = c["ex1"] + c["ex"] + c["ey1"] + c["ey"]
        return (-f + c["ex1"] * xp + c["ex"] * xm + c["ey1"] * yp +
                c["ey"] * ym) / den
    den = c["al"] - c["ex1"] - c["ex"] - c["ey1"] - c["ey"]
    return (f - (c["ex1"] + c["gx"]) * xp - (c["ex"] - c["gx"]) * xm -
            (c["ey1"] + c["gy"]) * yp - (c["ey"] - c["gy"]) * ym) / den


def _resid(mg, op, g, f, v, xp, xm, yp, ym, c):
    """The plain residual, in its order of operations."""
    if op == "const":
        lap = ((xm + xp - 2.0 * v) / g.dx ** 2 +
               (ym + yp - 2.0 * v) / g.dy ** 2)
        return f - mg.alpha * v + mg.beta * lap
    if op == "vc":
        return f - (c["ex1"] * (xp - v) - c["ex"] * (v - xm) +
                    c["ey1"] * (yp - v) - c["ey"] * (v - ym))
    return f - (c["al"] * v + c["ex1"] * (xp - v) - c["ex"] * (v - xm) +
                c["ey1"] * (yp - v) - c["ey"] * (v - ym) +
                c["gx"] * (xp - xm) + c["gy"] * (yp - ym))


def _shift(a, di, dj):
    """b[r, s] = a[r + di, s + dj] (NaN where that leaves the box)."""
    b = torch.full_like(a, float("nan"))
    R, S = a.shape
    b[max(0, -di):R - max(0, di), max(0, -dj):S - max(0, dj)] = \
        a[max(0, di):R - max(0, -di), max(0, dj):S - max(0, -dj)]
    return b


def tile_round(mg, op, level, cur, f, ti, tj, tile, iters, halo=None):
    """One round of a tiled kernel on the tile whose first interior cell is
    (ti, tj): a box of `halo` (2 iters + 1 unless given) around it, loaded
    from frame cur, its 2 iters half-sweeps on the cells whose neighbours
    are still exact.  Asserts that the tile and the ring around it are
    exact after them ("the halo does not reach" otherwise), as the
    residual needs; returns (the tile's values, the residual of the
    tile's cells)."""
    g = mg.grids[level]
    n = g.nx
    halo = 2 * iters + 1 if halo is None else halo
    bc = mg.bc_v[level]
    per = (bc.xlb == "periodic", bc.ylb == "periodic")
    kinds = mg_kernel.edge_kinds(bc)
    sign = [[SIGN[kinds[0]], SIGN[kinds[1]]],
            [SIGN[kinds[2]], SIGN[kinds[3]]]]
    cf = _coefs(mg, op, level)
    # the box's extended indices, their interior cells, whether a box cell
    # holds one
    ext = [torch.arange(t0 - halo, t0 + tile + halo) for t0 in (ti, tj)]
    true = [((e - 1) % n) + 1 if p else e.clamp(1, n)
            for e, p in zip(ext, per)]
    held = [torch.ones_like(e, dtype=torch.bool) if p else
            (e >= 1) & (e <= n) for e, p in zip(ext, per)]
    I, J = true[0][:, None], true[1][None, :]
    valid = held[0][:, None] & held[1][None, :]
    B = torch.where(valid, cur[I, J],
                    torch.tensor(float("nan"), dtype=f.dtype))
    F = f[I, J]
    c = {}
    for name, a in cf.items():
        c[name] = a[I, J]
    if "ex" in cf:
        c["ex1"] = cf["ex"][I + 1, J]
        c["ey1"] = cf["ey"][I, J + 1]
    Ei, Ej = ext[0][:, None], ext[1][None, :]
    lo = [(~torch.tensor(p)) & (e == 1) for e, p in
          ((Ei, per[0]), (Ej, per[1]))]
    hi = [(~torch.tensor(p)) & (e == n) for e, p in
          ((Ei, per[0]), (Ej, per[1]))]

    # a neighbour across a non-periodic edge is read as the sign times the
    # cell (-0 for a negative cell on a ZERO edge, as the kernels read it)
    def nbrs(B):
        return (torch.where(hi[0], sign[0][1] * B, _shift(B, 1, 0)),
                torch.where(lo[0], sign[0][0] * B, _shift(B, -1, 0)),
                torch.where(hi[1], sign[1][1] * B, _shift(B, 0, 1)),
                torch.where(lo[1], sign[1][0] * B, _shift(B, 0, -1)))

    def nbrs_exact(X):
        Xf = X.to(torch.float64)
        ok = [torch.where(h, Xf, _shift(Xf, di, dj)) == 1.0
              for h, di, dj in ((hi[0], 1, 0), (lo[0], -1, 0),
                                (hi[1], 0, 1), (lo[1], 0, -1))]
        return ok[0] & ok[1] & ok[2] & ok[3]

    exact = valid.clone()
    red = ((Ei + Ej) % 2) == 0
    for s in range(2 * iters):
        colour = red if s % 2 == 0 else ~red
        can = valid & colour & nbrs_exact(exact)
        B = torch.where(can, _gs(mg, op, g, F, *nbrs(B), c), B)
        exact = exact & (~colour | can)
    sl = (slice(halo, halo + tile), slice(halo, halo + tile))
    ring = (slice(halo - 1, halo + tile + 1),
            slice(halo - 1, halo + tile + 1))
    assert bool(exact[ring][valid[ring]].all()), "the halo does not reach"
    r = _resid(mg, op, g, F, B, *nbrs(B), c)
    return B[sl], r[sl]


def _tile_schedule(mg, op, level, v, f, vc, want_r, tile, rounds):
    """mg_up's result computed tile by tile as k_up computes it: per round
    a box of halo 2 iters + 1 around each tile, its half-sweeps on the
    cells whose neighbours are still exact."""
    g = mg.grids[level]
    n = g.nx
    cur = v + prolong_array(vc, mg.grids[level - 1], g)
    r_out = torch.zeros_like(f)
    for k, iters in enumerate(rounds):
        new = cur.clone()
        for ti in range(1, n + 1, tile):
            for tj in range(1, n + 1, tile):
                B, r = tile_round(mg, op, level, cur, f, ti, tj, tile, iters)
                new[ti:ti + tile, tj:tj + tile] = B
                if want_r and k == len(rounds) - 1:
                    r_out[ti:ti + tile, tj:tj + tile] = r
        cur = new
    return put_ghosts(mg, level, cur), (r_out if want_r else None)


CASES = [(op, edge, dtype) for op in ("const", "vc", "general")
         for edge in ("neumann", "periodic", "dirichlet", "cavity")
         if edge != "cavity" or op == "const"
         for dtype in (torch.float64, torch.float32)]


@pytest.mark.parametrize("op,edge,dtype", CASES)
def test_up_tiles_match_the_plain_ascent(op, edge, dtype):
    """32^2 in 8^2 tiles at nsmooth 10 (one round, halo 21: the box holds
    the level several times over on a periodic axis), and 64^2 in 16^2
    tiles at nsmooth 5 in rounds of 2, 2 and 1, with the residual; and the
    plan tile_plan makes for each, its tile and halo as the kernel takes
    them."""
    rng = np.random.default_rng(7)
    for n, nsmooth, tile, rounds in ((32, 10, 8, [10]),
                                     (64, 5, 16, [2, 2, 1])):
        mg = make_mg(op, n, edge, dtype)
        mg.nsmooth = nsmooth
        level = mg.nlevels - 1
        g, gc = mg.grids[level], mg.grids[level - 1]
        v = torch.as_tensor(0.1 * rng.standard_normal((g.qx, g.qy)),
                            dtype=dtype)
        f = torch.as_tensor(rng.standard_normal((g.qx, g.qy)), dtype=dtype)
        vc = torch.as_tensor(0.1 * rng.standard_normal((gc.qx, gc.qy)),
                             dtype=dtype)
        ref_v, ref_r = mg_kernel.up_plain(mg, level, v, f, vc, True)
        plan = mg_kernel.tile_plan(n, nsmooth, dtype, op)
        for t, rs in ((tile, rounds), (plan.tile, plan.round_iters())):
            got_v, got_r = _tile_schedule(mg, op, level, v, f, vc, True, t,
                                          rs)
            assert same_bits(got_v, ref_v), (n, t, rs)
            assert same_bits(got_r, ref_r), (n, t, rs)


@pytest.mark.parametrize("op,edge,dtype", CASES)
def test_up_plan_tiles_of_the_register_smoother_match(op, edge, dtype):
    """The tile side the constant operator's plan takes at 4096^2 and
    2048^2 in both dtypes (64, halo 21, one round at nsmooth 10: the box
    of v and f no longer bounds the float64 tile) at 128^2, which holds
    2^2 of them: v with its
    ghosts and the residual bit for bit as up_plain gives them, for every
    operator and edge kind."""
    plan = mg_kernel.tile_plan(4096, 10, dtype)
    assert plan.tile == mg_kernel.tile_plan(2048, 10, dtype).tile == 64
    assert (plan.halo, plan.round_iters()) == (21, [10])
    n = 128
    rng = np.random.default_rng(17)
    mg = make_mg(op, n, edge, dtype)
    mg.nsmooth = 10
    level = mg.nlevels - 1
    g, gc = mg.grids[level], mg.grids[level - 1]
    v = torch.as_tensor(0.1 * rng.standard_normal((g.qx, g.qy)), dtype=dtype)
    f = torch.as_tensor(rng.standard_normal((g.qx, g.qy)), dtype=dtype)
    vc = torch.as_tensor(0.1 * rng.standard_normal((gc.qx, gc.qy)),
                         dtype=dtype)
    ref_v, ref_r = mg_kernel.up_plain(mg, level, v, f, vc, True)
    got_v, got_r = _tile_schedule(mg, op, level, v, f, vc, True, plan.tile,
                                  plan.round_iters())
    assert same_bits(got_v, ref_v)
    assert same_bits(got_r, ref_r)
