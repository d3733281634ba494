"""Iterative refinement for deep-tolerance float32 multigrid solves.

The port of pyro2_tpu/multigrid/refine.py.  A float32 solve stalls at a
relative residual of ~1e-6 to ~1e-4 (the larger the grid, the higher):
r = f - A x computed in float32 loses the answer to cancellation once x is
accurate to float32's epsilon.  Iterative refinement recovers it when the
RESIDUAL is computed in higher precision.  Here that is double-f32
(compensated) arithmetic: the solution is carried as an unevaluated
float32 pair x = hi + lo (~48-bit mantissa), and r = f - alpha x + beta L x
is evaluated with error-free transformations (Knuth's TwoSum, Dekker's
TwoProd), accurate to ~1e-14 relative while every operation stays a
float32 one.  The correction solve A e = round_f32(r) is the MG object's
own `solve` at a loose tolerance, so on CUDA it launches the V-cycle
kernels unchanged (mg_core, mg_down, mg_up; on a ShardedMG mg_deep_smooth,
mg_correct and mg_core): e needs only a few digits.  2-3 passes reach
rtol 1e-10 where the direct float32 solve stalls.

The transformations are plain tensor code, one torch operation a product
or a sum, so that none is contracted into a fused multiply-add: an FMA
would break `_split`'s c - (c - a), and TwoProd's error term with it.

Homogeneous standard BCs and the constant-coefficient operator only, as
in the JAX package; anything else raises ValueError.
"""

import numpy as np
import torch
import torch.nn.functional as F

from pyro2_tpu_torch.mesh.indexer import ai, embed, fill_ghost

__all__ = ["two_sum", "two_prod", "solve_ir", "solve_ir_sharded"]

_SPLIT = 4097.0  # 2^12 + 1 (Dekker's split constant for float32's 24 bits)

_STANDARD = ("outflow", "neumann", "dirichlet", "reflect-odd",
             "reflect-even", "periodic")


def two_sum(a, b):
    """Knuth's TwoSum: s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker's TwoProd: p + e == a * b exactly (no FMA needed)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _c_pair(value, like):
    """A Python float coefficient as a (hi, lo) pair of 0-d tensors of
    like's dtype and device."""
    npdt = np.float32 if like.dtype == torch.float32 else np.float64
    hi = npdt(value)
    lo = npdt(value - float(hi))
    return (torch.tensor(hi, dtype=like.dtype, device=like.device),
            torch.tensor(lo, dtype=like.dtype, device=like.device))


def _residual_df32(g, f, xh, xl, coeffs):
    """r = f - alpha x + beta L x with x = xh + xl (ghosts filled), summed
    with compensation on the interior.

    coeffs: (c_diag, c_x, c_y), the operator's diagonal
    (-alpha - 2 beta/dx^2 - 2 beta/dy^2) and neighbour (beta/dx^2,
    beta/dy^2) weights, so r = f + c_diag xc + c_x (xW + xE) + c_y (xS + xN).
    Returns the residual rounded to the working dtype (ghosts zero)."""
    vh, vl = ai(xh, g), ai(xl, g)
    c_diag, c_x, c_y = coeffs
    terms = []
    for c, wins in ((c_diag, [(vh.v(), vl.v())]),
                    (c_x, [(vh.ip(-1), vl.ip(-1)), (vh.ip(1), vl.ip(1))]),
                    (c_y, [(vh.jp(-1), vl.jp(-1)), (vh.jp(1), vl.jp(1))])):
        ch, cl = _c_pair(c, f)
        for wh, wl in wins:
            terms.append((ch, cl, wh, wl))

    # a compensated dot product (Ogita, Rump and Oishi's Dot2): s carries
    # the leading part, e the accumulated roundoff
    s = ai(f, g).v()
    e = torch.zeros_like(s)
    for ch, cl, wh, wl in terms:
        p, pe = two_prod(ch, wh)
        s, se = two_sum(s, p)
        e = e + se + pe + ch * wl + cl * wh
    return embed(s + e, g)


def _coeffs(alpha, beta, g):
    c_x = beta / g.dx ** 2
    c_y = beta / g.dy ** 2
    return (-alpha - 2.0 * c_x - 2.0 * c_y, c_x, c_y)


def _accumulate(xh, xl, e):
    """x <- x + e in double-f32 (a TwoSum renormalization)."""
    s, err = two_sum(xh, e)
    return two_sum(s, xl + err)


def _refine(mg, f, residual, correction, rtol, max_iter):
    """The refinement loop shared by the serial and the sharded solve:
    (xh, xl, residual error, passes).  Stops below rtol, or when a pass
    gains less than 0.7x (the double-f32 floor)."""
    fnorm = mg.source_norm if mg.source_norm != 0.0 else 1.0
    xh = torch.zeros_like(f)
    xl = torch.zeros_like(f)
    res = None
    n_ref = 0
    prev = float("inf")
    for n_ref in range(1, max_iter + 1):
        r, rnorm = residual(xh, xl)
        res = float(rnorm) / fnorm
        if res < rtol or res > 0.7 * prev:
            break
        prev = res
        mg.init_zeros()
        mg.init_RHS(r)
        xh, xl = _accumulate(xh, xl, correction())
    return xh, xl, res, n_ref


def solve_ir(mg, rtol=1.e-10, max_iter=20, inner_rtol=1.e-5):
    """Deep-tolerance solve on a CellCenterMG2d by iterative refinement.

    Each correction is mg's own solve (its V-cycle kernels on CUDA) at
    inner_rtol; the solution accumulates in double-f32.  Sets mg.v[-1] to
    the hi part (ghosts filled) and mg.v_lo to the lo part, restores f and
    the source norm, sets residual_error and num_cycles (the passes);
    returns (residual_error, passes)."""
    from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d

    if not mg.initialized_rhs:
        raise ValueError("RHS not initialized")
    if type(mg) is not CellCenterMG2d:
        raise ValueError("iterative refinement supports the constant-"
                         "coefficient CellCenterMG2d")
    for bc_l in mg.bc_v:
        for edge in ("xlb", "xrb", "ylb", "yrb"):
            if getattr(bc_l, edge) not in _STANDARD:
                raise ValueError("refinement requires standard BCs")
        if any(v is not None for v in (bc_l.xl_value, bc_l.xr_value,
                                       bc_l.yl_value, bc_l.yr_value)):
            raise ValueError("refinement requires homogeneous BCs")

    g = mg.soln_grid
    f = mg.f[-1]
    coeffs = _coeffs(mg.alpha, mg.beta, g)
    bc = mg.bc_v[-1]

    def residual(xh, xl):
        # the homogeneous standard fills are linear: filling hi and lo
        # apart is exact (in place: only the ghosts change)
        r = _residual_df32(g, f, fill_ghost(xh, g, bc),
                           fill_ghost(xl, g, bc), coeffs)
        return r, ai(r, g).norm()

    def correction():
        mg.solve(rtol=inner_rtol)
        return mg.v[-1]

    orig_source_norm = mg.source_norm
    xh, xl, res, n_ref = _refine(mg, f, residual, correction, rtol,
                                 max_iter)
    mg.f = mg.f[:-1] + [f]
    mg.source_norm = orig_source_norm
    mg.v[-1] = mg._fill_v(mg.nlevels - 1, xh)
    mg.v_lo = xl
    mg.residual_error = res
    mg.num_cycles = n_ref
    return res, n_ref


def solve_ir_sharded(smg, rtol=1.e-10, max_iter=20, inner_rtol=1.e-5):
    """Deep-tolerance solve on a ShardedMG by iterative refinement.

    The twin of solve_ir over a mesh of ranks: the double-f32 pair lives in
    each rank's block, the compensated residual runs per block behind a
    halo exchange (the homogeneous standard fills are linear, and seam
    ghosts are copies, so filling hi and lo apart is exact), the norms are
    summed over the mesh, and each correction is the sharded solve (on
    CUDA mg_deep_smooth, mg_correct and mg_core).  Collective: every rank
    calls it.  Sets smg.v_int (hi) and smg.v_lo (lo), restores f_int and
    the source norm; returns (residual_error, passes)."""
    from pyro2_tpu_torch.parallel.mesh_comm import halo_exchange

    if not smg.initialized_rhs:
        raise ValueError("RHS not initialized")
    if type(smg).__name__ != "ShardedMG":
        raise ValueError("sharded refinement supports the constant-"
                         "coefficient ShardedMG")

    g = smg.soln_grid
    lg = smg.local_grids[smg.nlevels - 1]
    f_int = smg.f_int
    coeffs = _coeffs(smg.serial.alpha, smg.serial.beta, g)
    bc, mesh = smg.bc, smg.mesh
    f_pad = F.pad(f_int, (1, 1, 1, 1))

    def residual(xh_i, xl_i):
        xh = halo_exchange(F.pad(xh_i, (1, 1, 1, 1)), lg, bc, mesh)
        xl = halo_exchange(F.pad(xl_i, (1, 1, 1, 1)), lg, bc, mesh)
        r_i = _residual_df32(lg, f_pad, xh, xl, coeffs)[1:-1, 1:-1]
        ss = mesh.psum(torch.sum(r_i ** 2))
        return r_i, torch.sqrt(g.dx * g.dy * ss)

    def correction():
        smg.solve(rtol=inner_rtol)
        return smg.v_int

    orig_source_norm = smg.source_norm
    xh, xl, res, n_ref = _refine(smg, f_int, residual, correction, rtol,
                                 max_iter)
    smg.f_int = f_int
    smg.source_norm = orig_source_norm
    smg.v_int = xh
    smg.v_lo = xl
    smg.residual_error = res
    smg.num_cycles = n_ref
    return res, n_ref
