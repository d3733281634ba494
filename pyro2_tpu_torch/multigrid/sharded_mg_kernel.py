"""The sharded multigrid's kernels on the H100
(pyro2_tpu_torch/csrc/mg_deep.cu) and their plain PyTorch versions.

The counterpart of pyro2_tpu/multigrid/pallas_sharded_mg.py:

  * `deep_smooth` (build_deep_smooth_kernel): one smoothing round on a
    block's deep frame -- the entry refresh of the physical ghosts,
    n_sweeps steps of red-black Gauss-Seidel, damped Jacobi or Chebyshev,
    each masked by the excess-distance eligibility and followed by the
    refresh, and by `emit` the frame ("v"), the frame and the factor-2
    restricted interior residual on the one-ghost coarse frame ("v_fc"),
    or the frame and the residual on the frame, zero outside the interior
    ("v_r");
  * `correct` (build_correct_kernel): v + prolong(vc) on the interior of a
    one-ghost block;
  * `sweep` (no TPU kernel: the card's form of the JAX package's jnp sweep
    smoother, which the plain structure of parallel/sharded_mg.py runs):
    on a block's one-ghost frame the refresh of the physical ghosts, one
    colour pass of red-black Gauss-Seidel (colour 0 red, 1 black, None no
    pass) and the refresh again, then by `emit` the frame ("v") or, after
    no pass, the frame and the factor-2 restricted residual ("v_fc") or
    the residual on the frame, zero in the ghosts ("v_r").

The replicated coarse solve reuses the serial kernels
(`mg_kernel.coarse_cycle`: the core, rows 8 and 13 of the kernel table,
as build_core_kernel and build_core_kernel_general did, and a down and an
up a level above the core's).

The plain versions (`deep_smooth_plain`, `correct_plain`, `sweep_plain`)
are the JAX jnp path's arithmetic: sharded_mg's `_deep_smooth` with
`_deep_gs_update`, then the serial `_residual` and `restrict_array`;
`prolong_array` and an add; one colour pass of the serial `_smooth_once`
between two ghost fills, then `_residual` and `restrict_array`.  For a
CPU tensor each entry runs its plain version; for a CUDA tensor it
launches its kernel, counting the launch in `launches`, or raises.  There
is no fallback from one to the other.

The operator is the constant one (ncoef 0: alpha, beta given as `ab`) or
a plane stack on the frame (`planes`: ncoef 2, the vc edge coefficients
[eta_x, eta_y]; ncoef 5, the general operator [alpha, beta_x, beta_y,
gamma_x/(2dx), gamma_y/(2dy)]), with homogeneous standard BCs.  `flags`
are the block's 8 flags [seam x-lo, x-hi, y-lo, y-hi, own x-lo, x-hi,
y-lo, y-hi] (sharded_mg.kernel_flags).
"""

import ctypes
import functools

import numpy as np
import torch

from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.mesh.patch import prolong_array, restrict_array
from pyro2_tpu_torch.multigrid import mg_kernel
from pyro2_tpu_torch.util import cuda_build

__all__ = ["DeepPlan", "EMITS", "SMOOTHERS", "SUPPORTED_BCS", "build",
           "correct", "correct_plain", "covered", "deep_plan", "deep_smooth",
           "deep_smooth_plain", "edge_plan", "launches", "sweep",
           "sweep_plain", "work"]

SOURCE = cuda_build.CSRC / "mg_deep.cu"

SMOOTHERS = ("rbgs", "jacobi", "chebyshev")
EMITS = ("v", "v_fc", "v_r")
# coefficient planes -> the operator of mg_ops.cuh
_OPERATORS = {0: ("const", 0), 2: ("vc", 1), 5: ("general", 2)}
SUPPORTED_BCS = frozenset(mg_kernel.BC_KIND)
_NEGATE = ("dirichlet", "reflect-odd")

# operations beyond the Gauss-Seidel update of one cell's step: Jacobi's
# damped move (3); Chebyshev's z, step and move (5)
_STEP_EXTRA = {"rbgs": 0, "jacobi": 3, "chebyshev": 5}

launches = {"mg_deep_smooth": 0, "mg_correct": 0, "mg_sweep": 0}

_lib = None


def build(verbose=False):
    """Compile mg_deep.cu (if its library is not built yet); returns
    (library path, seconds spent in nvcc, nvcc's stderr)."""
    return cuda_build.build(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        so, _, _ = build()
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        ints = ctypes.POINTER(i32)
        doubles = ctypes.POINTER(ctypes.c_double)
        for t in ("f32", "f64"):
            fn = getattr(lib, f"mg_deep_smooth_{t}")
            fn.argtypes = [ptr] * 7 + [ints, i32, i32, i32, ints, ints, ints,
                                       doubles, doubles, ints, ptr]
            fn.restype = i32
            fn = getattr(lib, f"mg_correct_{t}")
            fn.argtypes = [ptr] * 3 + [i32, i32, ptr]
            fn.restype = i32
            fn = getattr(lib, f"mg_sweep_{t}")
            fn.argtypes = [ptr] * 5 + [ints, i32, i32, i32, ints, ints, ints,
                                       doubles, doubles, ptr]
            fn.restype = i32
        lib.mg_deep_plan_ints.restype = i32
        if lib.mg_deep_plan_ints() != len(DeepPlan.FIELDS):
            raise RuntimeError("mg_deep.cu takes another deep plan layout")
        _lib = lib
    return _lib


def edge_plan(bc, px, py):
    """The refresh of each edge (x-lo, x-hi, y-lo, y-hi): 0 none, 1 where
    the block owns that domain edge (flags 4..7), 2 always (an unsplit
    periodic axis).  A split periodic axis needs none: the seam exchange is
    its periodic fill."""
    plan = []
    for p, lb in ((px, bc.xlb), (py, bc.ylb)):
        if lb == "periodic":
            plan += [2, 2] if p == 1 else [0, 0]
        else:
            plan += [1, 1]
    return plan


# ---------------------------------------------------------------------------
# the deep kernel's launch plan
# ---------------------------------------------------------------------------

# k_deep's block: rows of 32 threads (mg_deep.cu TILE_X), DEEP_THREADS in
# all.  The tile is square and even: the largest power of 2 up to
# mg_kernel.TILE_MAX that still gives mg_kernel.TILE_BLOCKS tiles or more
# and whose boxes hold a halo for all the round's sweeps, and not below
# TILE_MIN; the boxes of a block (v and f, Jacobi's second iterate,
# Chebyshev's dk) take at most mg_kernel.TILE_SMEM bytes, so that two
# blocks share an SM, as mg_down's and mg_up's tiles do
DEEP_THREADS = 512
# the halo cells a red-black sweep or a Jacobi / Chebyshev step reaches
REACH = {"rbgs": 2, "jacobi": 1, "chebyshev": 1}
# the arrays of a block's box: v, f; the second iterate; dk
ARRAYS = {"rbgs": 2, "jacobi": 3, "chebyshev": 4}


def _halo_tiles(dp, tile, halo):
    """The tiles of the deep halo on each side of the owned block along an
    axis: none when the block's edge tiles can take it (it is no deeper
    than their boxes' halo), else enough to cover it."""
    return 0 if dp <= halo else -(-dp // tile)


def _owned(k, tiles, tile, dp, b, halo):
    """The frame cells [o0, o1) along an axis that tile k writes: a tile of
    the halo below the owned block (the first ragged), a share of the owned
    block (its edge tiles with the halo beside them when the halo has no
    tiles), or a tile of the halo above it (the last ragged)."""
    nl = _halo_tiles(dp, tile, halo)
    nb, F = tiles - 2 * nl, b + 2 * dp
    if k < nl:
        o1 = dp - (nl - 1 - k) * tile
        return max(0, o1 - tile), o1
    if k >= nl + nb:
        o0 = dp + b + (k - nl - nb) * tile
        return o0, min(F, o0 + tile)
    m = k - nl
    return (0 if m == 0 and nl == 0 else dp + m * tile,
            (F if nl == 0 else dp + b) if m == nb - 1 else
            dp + (m + 1) * tile)


def _box(o0, o1, halo, F, wrap):
    """The box's extent along an axis: the owned span and the halo, clipped
    to the frame, or wrapped around an unsplit periodic axis."""
    if wrap:
        return o1 - o0 + 2 * halo
    return min(F, o1 + halo) - max(0, o0 - halo)


def _widest(tiles, tile, halo, dp, b, wrap):
    return max(_box(*_owned(k, tiles, tile, dp, b, halo), halo, b + 2 * dp,
                    wrap) for k in range(tiles))


class DeepPlan:
    """The tiling of one mg_deep_smooth call on a (bx + 2 dpx) x (by + 2
    dpy) frame: the tile (tx rows, ty columns), the halo (REACH per sweep of
    a sub-round, and one for the residual), the sub-rounds (separate
    launches) and the sweeps of a full one, the block's threads, its shared
    memory (bytes), the grid of tiles over the owned block (along y, along
    x), the widest box along x and along y, and the arrays of that size a
    block holds.  `wrap` says which axes are unsplit and periodic (their
    boxes wrap around).  `ints()` is the array the kernel takes."""

    FIELDS = ("tx", "ty", "halo", "rounds", "iters", "threads", "smem", "gx",
              "gy", "bh", "bw", "arrays")

    def __init__(self, bx, by, dpx, dpy, n_sweeps, smoother, dtype,
                 wrap=(False, False)):
        item = torch.empty((), dtype=dtype).element_size()
        reach, arrays = REACH[smoother], ARRAYS[smoother]
        Fx, Fy = bx + 2 * dpx, by + 2 * dpy

        def grid(tile, iters):
            halo = reach * iters + 1
            return (-(-by // tile) + 2 * _halo_tiles(dpy, tile, halo),
                    -(-bx // tile) + 2 * _halo_tiles(dpx, tile, halo))

        def boxes(tile, iters):
            gx, gy = grid(tile, iters)
            halo = reach * iters + 1
            return (_widest(gy, tile, halo, dpx, bx, wrap[0]),
                    _widest(gx, tile, halo, dpy, by, wrap[1]))

        def most(tile):                 # sweeps a sub-round's boxes hold
            for iters in range(n_sweeps, -1, -1):
                bh, bw = boxes(tile, iters)
                if arrays * bh * bw * item <= mg_kernel.TILE_SMEM:
                    return iters
            return -1

        tile = mg_kernel.TILE_MAX
        while tile > mg_kernel.TILE_MIN and (
                -(-bx // tile) * -(-by // tile) < mg_kernel.TILE_BLOCKS or
                most(tile) < n_sweeps):
            tile //= 2
        if n_sweeps == 0:
            rounds, iters = 1, 0
        else:
            if most(tile) < 1:
                raise ValueError(f"no tile of a ({Fx}, {Fy}) frame holds a "
                                 f"sweep of {smoother}")
            rounds = -(-n_sweeps // most(tile))
            iters = -(-n_sweeps // rounds)          # the rounds balanced
        self.n_sweeps, self.smoother = n_sweeps, smoother
        self.tx = self.ty = tile
        self.rounds, self.iters = rounds, iters
        self.halo = reach * iters + 1
        self.threads = DEEP_THREADS
        self.gx, self.gy = grid(tile, iters)
        self.bh, self.bw = boxes(tile, iters)
        self.arrays = arrays
        self.smem = arrays * self.bh * self.bw * item

    def round_iters(self):
        """The sweeps of each sub-round: a full one's, the last the
        rest."""
        return [min(self.iters, self.n_sweeps - k * self.iters)
                for k in range(self.rounds)]

    def ints(self):
        return [getattr(self, f) for f in self.FIELDS]


@functools.lru_cache(maxsize=128)
def deep_plan(bx, by, dpx, dpy, n_sweeps, smoother, dtype,
              wrap=(False, False)):
    """The plan of one mg_deep_smooth call (see DeepPlan), made once for
    each set of arguments."""
    return DeepPlan(bx, by, dpx, dpy, n_sweeps, smoother, dtype, wrap)


def covered(bx, by, dpx, dpy, edges):
    """Raise NotImplementedError unless the tiled kernel takes this frame:
    an axis whose ghosts wrap around (edge_plan 2: unsplit and periodic)
    has one cell of halo and a power-of-2 block, as the sharded levels'
    blocks are."""
    for b, dp, p in ((bx, dpx, edges[0]), (by, dpy, edges[2])):
        if p == 2 and (dp != 1 or b & (b - 1)):
            raise NotImplementedError(
                f"the tiled deep smoother wraps an unsplit periodic axis of "
                f"a power-of-2 block with one halo cell, not {b} cells with "
                f"{dp} (ROADMAP.md A.24)")


@functools.lru_cache(maxsize=64)
def _block_grids(bx, by):
    """One-ghost grids of a bx x by block and of its factor-2 coarsening
    (only their index ranges are read)."""
    return Grid2d(bx, by, ng=1), Grid2d(bx // 2, by // 2, ng=1)


def _geometry(vd, dpx, dpy):
    Fx, Fy = vd.shape[-2:]
    bx, by = Fx - 2 * dpx, Fy - 2 * dpy
    if bx < 2 or by < 2 or bx % 2 or by % 2 or dpx < 1 or dpy < 1:
        raise ValueError(f"a ({Fx}, {Fy}) frame with pad depths ({dpx}, "
                         f"{dpy}) holds no even block")
    return bx, by


def _check(smoother, emit, planes, ab, bc):
    if smoother not in SMOOTHERS:
        raise ValueError(f"unknown smoother '{smoother}'")
    if emit not in EMITS:
        raise ValueError(f"unknown emit '{emit}'")
    ncoef = 0 if planes is None else planes.shape[0]
    if ncoef not in _OPERATORS:
        raise ValueError(f"a plane stack of {ncoef} coefficients is no "
                         "operator (2: vc, 5: general)")
    if ncoef == 0 and ab is None:
        raise ValueError("the constant operator needs ab = (alpha, beta)")
    for kind in (bc.xlb, bc.xrb, bc.ylb, bc.yrb):
        if kind not in SUPPORTED_BCS:
            raise ValueError(f"BC '{kind}' is not supported by the sharded "
                             "multigrid kernels")
    return ncoef


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def _shifts(a):
    """a at i+1, i-1, j+1, j-1 over the whole frame (wrapping at its border,
    where no cell that may take an update reads)."""
    return (torch.roll(a, -1, -2), torch.roll(a, 1, -2),
            torch.roll(a, -1, -1), torch.roll(a, 1, -1))


def _operator(ncoef, ab, planes, dx, dy):
    """(Gauss-Seidel update, residual) of the operator on a frame, each a
    function of (v, f), in the serial operators' term order."""
    if ncoef == 0:
        alpha, beta = (float(c) for c in ab)
        xc, yc = beta / dx ** 2, beta / dy ** 2
        denom = alpha + 2.0 * xc + 2.0 * yc

        def update(v, f):
            vip, vim, vjp, vjm = _shifts(v)
            return (f + xc * (vip + vim) + yc * (vjp + vjm)) / denom

        def residual(v, f):
            vip, vim, vjp, vjm = _shifts(v)
            lap = ((vim + vip - 2.0 * v) / dx ** 2 +
                   (vjm + vjp - 2.0 * v) / dy ** 2)
            return f - alpha * v + beta * lap

        return update, residual
    if ncoef == 2:
        ex, ey = planes[0], planes[1]
        exp1, eyp1 = torch.roll(ex, -1, -2), torch.roll(ey, -1, -1)
        denom = exp1 + ex + eyp1 + ey

        def update(v, f):
            vip, vim, vjp, vjm = _shifts(v)
            return (-f + exp1 * vip + ex * vim + eyp1 * vjp +
                    ey * vjm) / denom

        def residual(v, f):
            vip, vim, vjp, vjm = _shifts(v)
            return f - (exp1 * (vip - v) - ex * (v - vim) +
                        eyp1 * (vjp - v) - ey * (v - vjm))

        return update, residual
    al, bx_, by_, gx, gy = (planes[n] for n in range(5))
    bxp, byp = torch.roll(bx_, -1, -2), torch.roll(by_, -1, -1)
    denom = al - bxp - bx_ - byp - by_

    def update(v, f):
        vip, vim, vjp, vjm = _shifts(v)
        return (f - (bxp + gx) * vip - (bx_ - gx) * vim -
                (byp + gy) * vjp - (by_ - gy) * vjm) / denom

    def residual(v, f):
        vip, vim, vjp, vjm = _shifts(v)
        return f - (al * v + bxp * (vip - v) - bx_ * (v - vim) +
                    byp * (vjp - v) - by_ * (v - vjm) +
                    gx * (vip - vim) + gy * (vjp - vjm))

    return update, residual


def _frame_masks(Fx, Fy, dpx, dpy, bx, by, device):
    ii = torch.arange(Fx, device=device)[:, None]
    jj = torch.arange(Fy, device=device)[None, :]
    ex = ((dpx - ii).clamp(min=0), (ii - (dpx + bx - 1)).clamp(min=0),
          (dpy - jj).clamp(min=0), (jj - (dpy + by - 1)).clamp(min=0))
    red = ((ii - dpx) + (jj - dpy)) % 2 == 0
    return ex, red


def _refresher(flags, bc, px, py, dpx, dpy, bx, by):
    """The refresh of a block frame's physical ghosts: a function that
    returns a copy of its frame with each edge the plan refreshes (flags
    4..7 own it, or an unsplit periodic axis) set to its sign times its
    source row or column, x-lo, x-hi, y-lo, y-hi over full rows, as
    fill_ghost orders them."""
    plan = edge_plan(bc, px, py)
    kinds = (bc.xlb, bc.xrb, bc.ylb, bc.yrb)

    def refresh(a):
        a = a.clone()
        for e in range(4):
            if not (plan[e] == 2 or (plan[e] == 1 and int(flags[4 + e]))):
                continue
            dim, hi = e // 2, e % 2
            dp, b = (dpx, bx) if dim == 0 else (dpy, by)
            ghost = dp + b if hi else dp - 1
            if kinds[e] == "periodic":          # an unsplit axis: dp = 1
                src = ghost - b if hi else ghost + b
            else:
                src = ghost - 1 if hi else ghost + 1
            row = a.select(dim, src)
            a.select(dim, ghost).copy_(-row if kinds[e] in _NEGATE else row)
        return a

    return refresh


def deep_smooth_plain(vd, fd, flags, *, dpx, dpy, d, n_sweeps, dx, dy, bc,
                      px, py, ab=None, planes=None, emit="v",
                      smoother="rbgs"):
    """(frame, restricted residual / residual frame / None): the plain
    version of one smoothing round (see the module docstring)."""
    ncoef = _check(smoother, emit, planes, ab, bc)
    bx, by = _geometry(vd, dpx, dpy)
    Fx, Fy = vd.shape
    (exl, exr, eyl, eyr), red = _frame_masks(Fx, Fy, dpx, dpy, bx, by,
                                             vd.device)
    seam = [int(s) != 0 for s in flags[:4]]
    update, residual = _operator(ncoef, ab, planes, dx, dy)
    refresh = _refresher(flags, bc, px, py, dpx, dpy, bx, by)

    def elig(lim):
        return ((exl <= (lim if seam[0] else 0)) &
                (exr <= (lim if seam[1] else 0)) &
                (eyl <= (lim if seam[2] else 0)) &
                (eyr <= (lim if seam[3] else 0)))

    v = refresh(vd)
    if smoother == "rbgs":
        for s in range(n_sweeps):
            lim = d - (2 * s + 1)
            v = refresh(torch.where(elig(lim) & red, update(v, fd), v))
            v = refresh(torch.where(elig(lim - 1) & ~red, update(v, fd), v))
    elif smoother == "jacobi":
        for s in range(n_sweeps):
            m = elig(d - (s + 1))
            v = refresh(torch.where(m, v + 0.8 * (update(v, fd) - v), v))
    else:
        # Chebyshev acceleration of the Jacobi iteration; its scalars in
        # the working type, in the JAX package's order
        T = np.float32 if vd.dtype == torch.float32 else np.float64
        theta, delta = T(1.25), T(0.75)
        sigma = theta / delta
        rho = T(1.0) / sigma
        dk = None
        for s in range(n_sweeps):
            m = elig(d - (s + 1))
            z = torch.where(m, update(v, fd) - v, 0.0)
            if s == 0:
                dk = z / float(theta)
            else:
                rho_new = T(1.0) / (T(2.0) * sigma - rho)
                dk = (float(rho_new * rho) * dk +
                      float(T(2.0) * rho_new / delta) * z)
                rho = rho_new
            v = refresh(torch.where(m, v + dk, v))
    if emit == "v":
        return v, None
    inside = (exl == 0) & (exr == 0) & (eyl == 0) & (eyr == 0)
    r = torch.where(inside, residual(v, fd), 0.0)
    if emit == "v_r":
        return v, r
    fine, coarse = _block_grids(bx, by)
    return v, restrict_array(r[dpx - 1:dpx + bx + 1, dpy - 1:dpy + by + 1],
                             fine, coarse)


def _sweep_geometry(v, colour, emit):
    """(bx, by) of a one-ghost frame the half-sweep takes; raises
    NotImplementedError for a block whose local parity could not be the
    global one, ValueError for a call it does not make."""
    bx, by = v.shape[-2] - 2, v.shape[-1] - 2
    if bx < 2 or by < 2 or bx % 2 or by % 2:
        raise NotImplementedError(
            f"the half-sweep kernel takes even blocks of 2 or more cells a "
            f"side, whose local red-black parity is the global one, not "
            f"{bx} x {by} (ROADMAP.md A.31)")
    if colour not in (None, 0, 1):
        raise ValueError(f"colour {colour!r}: 0 (red), 1 (black) or None")
    if emit not in EMITS:
        raise ValueError(f"unknown emit '{emit}'")
    if emit != "v" and colour is not None:
        raise ValueError("a residual is emitted after no colour pass only: "
                         "the seam ghosts of a pass are stale until the "
                         "exchange")
    return bx, by


def sweep_plain(v, f, flags, *, colour, dx, dy, bc, px, py, ab=None,
                planes=None, emit="v"):
    """(frame, restricted residual / residual frame / None): the plain
    version of one half-sweep call (see the module docstring): the serial
    `_smooth_once`'s pass of one colour between two fills of the physical
    ghosts, or no pass, then `_residual` and `restrict_array`."""
    ncoef = _check("rbgs", emit, planes, ab, bc)
    bx, by = _sweep_geometry(v, colour, emit)
    refresh = _refresher(flags, bc, px, py, 1, 1, bx, by)
    update, residual = _operator(ncoef, ab, planes, dx, dy)
    (exl, exr, eyl, eyr), red = _frame_masks(bx + 2, by + 2, 1, 1, bx, by,
                                             v.device)
    inside = (exl == 0) & (exr == 0) & (eyl == 0) & (eyr == 0)
    v = refresh(v)
    if colour is not None:
        mask = inside & (red if colour == 0 else ~red)
        v = refresh(torch.where(mask, update(v, f), v))
    if emit == "v":
        return v, None
    r = torch.where(inside, residual(v, f), 0.0)
    if emit == "v_r":
        return v, r
    fine, coarse = _block_grids(bx, by)
    return v, restrict_array(r, fine, coarse)


def correct_plain(v, vc):
    """v + prolong(vc) on the interior of the one-ghost block v; the
    ghosts as they were."""
    bx, by = v.shape[-2] - 2, v.shape[-1] - 2
    fine, coarse = _block_grids(bx, by)
    e = prolong_array(vc, coarse, fine)
    out = v.clone()
    out[1:-1, 1:-1] += e[1:-1, 1:-1]
    return out


# ---------------------------------------------------------------------------
# the kernel launches
# ---------------------------------------------------------------------------

def _frame_ok(a, shape, dtype, what):
    if a.device.type != "cuda":
        raise ValueError(f"the sharded multigrid kernels take CUDA tensors "
                         f"({what} is on {a.device})")
    if a.dtype != dtype or dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: expected {dtype} (float32 or float64), "
                        f"got {a.dtype}")
    if tuple(a.shape) != tuple(shape) or not a.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {tuple(shape)} "
                         f"tensor, got {tuple(a.shape)}")
    return a.data_ptr()


def _run(fn, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"sharded multigrid kernel launch failed: CUDA "
                           f"error {err}")


def launch_deep_smooth(vd, fd, flags, *, dpx, dpy, d, n_sweeps, dx, dy, bc,
                       px, py, ab=None, planes=None, emit="v",
                       smoother="rbgs"):
    """The CUDA kernel of one smoothing round: (frame, extra or None)."""
    ncoef = _check(smoother, emit, planes, ab, bc)
    bx, by = _geometry(vd, dpx, dpy)
    shape, dtype = tuple(vd.shape), vd.dtype
    ptrs = [_frame_ok(vd, shape, dtype, "vd"), _frame_ok(fd, shape, dtype,
                                                         "fd")]
    ptrs.append(None if planes is None else _frame_ok(
        planes, (ncoef,) + shape, dtype, "planes"))
    edges = edge_plan(bc, px, py)
    covered(bx, by, dpx, dpy, edges)
    tiles = deep_plan(bx, by, dpx, dpy, n_sweeps, smoother, dtype,
                      (edges[0] == 2, edges[2] == 2))
    vo = torch.empty_like(vd)
    extra = None
    if emit == "v_fc":
        extra = vd.new_empty((bx // 2 + 2, by // 2 + 2))
    elif emit == "v_r":
        extra = torch.empty_like(vd)
    # the sub-rounds' scratch frame, and Chebyshev's dk between them
    w = torch.empty_like(vd) if tiles.rounds > 1 else None
    dk = vd.new_empty((2,) + shape) if (smoother == "chebyshev" and
                                        tiles.rounds > 1) else None
    if ncoef == 0:
        alpha, beta = (float(c) for c in ab)
        xc, yc = beta / dx ** 2, beta / dy ** 2
        coef = [xc, yc, alpha + 2.0 * xc + 2.0 * yc, dx ** 2, dy ** 2]
    else:
        alpha, beta, coef = 0.0, 0.0, [0.0] * 5
    kinds = [mg_kernel.BC_KIND[k] for k in (bc.xlb, bc.xrb, bc.ylb, bc.yrb)]
    ints = ctypes.c_int
    t = "f32" if dtype == torch.float32 else "f64"
    _run(getattr(_load(), f"mg_deep_smooth_{t}"), vd.device, *ptrs,
         vo.data_ptr(), None if extra is None else extra.data_ptr(),
         None if w is None else w.data_ptr(),
         None if dk is None else dk.data_ptr(),
         (ints * 6)(bx, by, dpx, dpy, d, n_sweeps),
         _OPERATORS[ncoef][1], SMOOTHERS.index(smoother), EMITS.index(emit),
         (ints * 8)(*(int(f) for f in flags)), (ints * 4)(*edges),
         (ints * 4)(*kinds), (ctypes.c_double * 5)(*coef),
         (ctypes.c_double * 2)(alpha, beta),
         (ints * len(DeepPlan.FIELDS))(*tiles.ints()))
    launches["mg_deep_smooth"] += 1
    return vo, extra


def launch_correct(v, vc):
    """The CUDA kernel of v + prolong(vc) on the interior."""
    bx, by = v.shape[-2] - 2, v.shape[-1] - 2
    if bx < 2 or by < 2 or bx % 2 or by % 2:
        raise ValueError(f"a ({bx + 2}, {by + 2}) frame holds no even block")
    p_v = _frame_ok(v, (bx + 2, by + 2), v.dtype, "v")
    p_c = _frame_ok(vc, (bx // 2 + 2, by // 2 + 2), v.dtype, "vc")
    out = torch.empty_like(v)
    t = "f32" if v.dtype == torch.float32 else "f64"
    _run(getattr(_load(), f"mg_correct_{t}"), v.device, p_v, p_c,
         out.data_ptr(), bx, by)
    launches["mg_correct"] += 1
    return out


def launch_sweep(v, f, flags, *, colour, dx, dy, bc, px, py, ab=None,
                 planes=None, emit="v"):
    """The CUDA kernel of one half-sweep call: (frame, extra or None)."""
    ncoef = _check("rbgs", emit, planes, ab, bc)
    bx, by = _sweep_geometry(v, colour, emit)
    shape, dtype = tuple(v.shape), v.dtype
    ptrs = [_frame_ok(v, shape, dtype, "v"), _frame_ok(f, shape, dtype, "f"),
            None if planes is None else _frame_ok(
                planes, (ncoef,) + shape, dtype, "planes")]
    vo = torch.empty_like(v)
    extra = None
    if emit == "v_fc":
        extra = v.new_empty((bx // 2 + 2, by // 2 + 2))
    elif emit == "v_r":
        extra = torch.empty_like(v)
    if ncoef == 0:
        alpha, beta = (float(c) for c in ab)
        xc, yc = beta / dx ** 2, beta / dy ** 2
        coef = [xc, yc, alpha + 2.0 * xc + 2.0 * yc, dx ** 2, dy ** 2]
    else:
        alpha, beta, coef = 0.0, 0.0, [0.0] * 5
    kinds = [mg_kernel.BC_KIND[k] for k in (bc.xlb, bc.xrb, bc.ylb, bc.yrb)]
    ints = ctypes.c_int
    t = "f32" if dtype == torch.float32 else "f64"
    _run(getattr(_load(), f"mg_sweep_{t}"), v.device, *ptrs, vo.data_ptr(),
         None if extra is None else extra.data_ptr(), (ints * 2)(bx, by),
         _OPERATORS[ncoef][1], -1 if colour is None else colour,
         EMITS.index(emit), (ints * 8)(*(int(x) for x in flags)),
         (ints * 4)(*edge_plan(bc, px, py)), (ints * 4)(*kinds),
         (ctypes.c_double * 5)(*coef), (ctypes.c_double * 2)(alpha, beta))
    launches["mg_sweep"] += 1
    return vo, extra


# ---------------------------------------------------------------------------
# the entries: the kernel for CUDA tensors, the plain version on the CPU
# ---------------------------------------------------------------------------

def deep_smooth(vd, fd, flags, **kw):
    if vd.device.type == "cpu":
        return deep_smooth_plain(vd, fd, flags, **kw)
    return launch_deep_smooth(vd, fd, flags, **kw)


def correct(v, vc):
    if v.device.type == "cpu":
        return correct_plain(v, vc)
    return launch_correct(v, vc)


def sweep(v, f, flags, **kw):
    if v.device.type == "cpu":
        return sweep_plain(v, f, flags, **kw)
    return launch_sweep(v, f, flags, **kw)


# ---------------------------------------------------------------------------
# the least work of each entry
# ---------------------------------------------------------------------------

def _eligible(bx, by, dpx, dpy, seam, lim, color=None):
    """How many frame cells may take an update at depth lim (of one
    colour: 0 red, 1 black)."""
    ii = np.arange(bx + 2 * dpx)[:, None]
    jj = np.arange(by + 2 * dpy)[None, :]
    m = ((np.maximum(dpx - ii, 0) <= (lim if seam[0] else 0)) &
         (np.maximum(ii - (dpx + bx - 1), 0) <= (lim if seam[1] else 0)) &
         (np.maximum(dpy - jj, 0) <= (lim if seam[2] else 0)) &
         (np.maximum(jj - (dpy + by - 1), 0) <= (lim if seam[3] else 0)))
    if color is not None:
        m &= ((ii - dpx) + (jj - dpy)) % 2 == color
    return int(m.sum())


def work(entry, *, bx, by, dtype, dpx=1, dpy=1, d=1, n_sweeps=0,
         flags=(0, 0, 0, 0, 1, 1, 1, 1), smoother="rbgs", emit="v",
         ncoef=0, colour=None):
    """(bytes, operations) one call must move and do at least: each input
    frame and plane read once, each output written once, and the
    operations of the cell updates this call's flags and depth allow, or
    (mg_sweep) of its colour's cells (counted from mg_deep.cu as mg_kernel
    counts them).  `entry` is "mg_deep_smooth", "mg_correct" or
    "mg_sweep"."""
    item = torch.empty((), dtype=dtype).element_size()
    qc = (bx // 2 + 2) * (by // 2 + 2)
    if entry == "mg_correct":
        return (2 * (bx + 2) * (by + 2) + qc) * item, \
            mg_kernel.FLOPS_PROLONG * bx * by
    if entry not in ("mg_deep_smooth", "mg_sweep"):
        raise ValueError(f"unknown entry {entry}")
    op = _OPERATORS[ncoef][0]
    if entry == "mg_sweep":
        dpx = dpy = 1
    nf = (bx + 2 * dpx) * (by + 2 * dpy)
    frames = (3 + ncoef) * nf + {"v": 0, "v_fc": qc, "v_r": nf}[emit]
    seam = [int(s) != 0 for s in flags[:4]]
    cells = 0
    if entry == "mg_sweep" and colour is not None:
        cells = bx * by // 2                 # an even block: half a colour
    for s in range(n_sweeps if entry == "mg_deep_smooth" else 0):
        if smoother == "rbgs":
            lim = d - (2 * s + 1)
            cells += (_eligible(bx, by, dpx, dpy, seam, lim, 0) +
                      _eligible(bx, by, dpx, dpy, seam, lim - 1, 1))
        else:
            cells += _eligible(bx, by, dpx, dpy, seam, d - (s + 1))
    ops = (mg_kernel.FLOPS_GS[op] + _STEP_EXTRA[smoother]) * cells
    if emit != "v":
        ops += mg_kernel.FLOPS_RESID[op] * bx * by
    if emit == "v_fc":
        ops += mg_kernel.FLOPS_RESTRICT * (bx // 2) * (by // 2)
    return frames * item, ops
