"""The fused multigrid V-cycle on the H100 (pyro2_tpu_torch/csrc/mg_vcycle.cu)
and its plain PyTorch version.

The counterpart of pyro2_tpu/multigrid/pallas_mg.py (the constant
operator) and pallas_gen_mg.py (the coefficient operators).  A cycle runs
as `downs -> core -> ups`, the assembly of the JAX package's
`build_fused_cycle` and `build_fused_cycle_general`:

  * `core` runs the whole sub-V-cycle of levels 0..top in one kernel (one
    thread block or a cluster of them, the level frames in shared memory
    as `core_plan` lays them out; each level on the warps `core_schedule`
    gives it), and writes the residual when no level is peeled;
  * each finer, peeled level adds one `down` (pre-smooth, residual,
    restrict) and one `up` (prolong and correct, post-smooth, and the
    residual on the finest level), which run their sweeps on tiles with
    deep halos in shared memory, as `tile_plan` lays them out: one
    ordinary launch at the solvers' nsmooth, several rounds where a halo
    for all of them would not fit.

One cycle launches 1 core and 1 down plus 1 up per peeled level, as the
TPU's did.  Which levels the core holds is a property of the card's shared
memory, not of the TPU's VMEM: `CORE_MAX` below, the same for every
operator (the coefficient planes stay in device memory).  The TPU's
row-banded kernels for levels above 512^2 have no counterpart: `down` and
`up` take a level of any size, periodic edges included.

The operator picks the entries (`FLAVOURS`): CellCenterMG2d runs
mg_core / mg_down / mg_up, VarCoeffCCMG2d the `_vc` entries with its
(eta_x, eta_y) planes, GeneralMG2d the `_general` entries with its five
planes; each entry counts its launches under its own name in `launches`.

For a CUDA tensor each entry launches its kernel, counting the launch, or
raises; for a CPU tensor it runs its plain version (`core_plain`,
`down_plain`, `up_plain`, composed from the MG object's own smoother and
residual and mesh.patch's restrict and prolong).  There is no fallback
from one to the other.  The kernels take those three classes with ng=1 on
a square power-of-2 grid and standard BCs, and one extended BC, the
lid-driven cavity's moving lid on the top edge (`edge_kinds`); anything
else raises `Ineligible` (a NotImplementedError) on CUDA, naming its
ROADMAP item.

The kernels fill every ghost homogeneously.  BC values (the finest
level's alone: the coarse levels hold corrections) reach them through the
right-hand side: `cycle` hands them `kernel_rhs(mg, f)` on the finest
level and refills its ghosts with the values after.  On the CPU the plain
entries fill the values inside the cycle, as the JAX package's cycle
does.
"""

import copy
import ctypes
import functools
import math

import torch

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.mesh.indexer import fill_ghost
from pyro2_tpu_torch.mesh.patch import prolong_array, restrict_array
from pyro2_tpu_torch.util import cuda_build

__all__ = ["CORE_MAX", "FLAVOURS", "Ineligible", "ZERO", "build", "check",
           "core", "core_cells", "core_cluster", "core_offsets",
           "core_plain", "core_plan", "core_schedule", "cycle", "down",
           "down_plain", "edge_kinds", "flavour", "has_values",
           "kernel_rhs", "launches", "lifted_rhs", "split", "tile_plan",
           "up", "up_plain", "TilePlan", "work"]

SOURCE = cuda_build.CSRC / "mg_vcycle.cu"

# finest level run inside the core kernel, by dtype: v and f of every core
# level must fit in the 227 KB of shared memory a block may use (levels
# 2^2..128^2 in float32: 183 KB; 2^2..64^2 in float64: 96 KB)
CORE_MAX = {torch.float32: 128, torch.float64: 64}

# the core's block: at most 32 warps; each level runs on the first
# core_schedule(...)[level] of them
CORE_WARPS = 32
# the levels of CLUSTER_N or more cells a side are spread over a cluster of
# CORE_CTAS blocks, one SM each, by rows (one SM's instruction throughput
# sets the pace of the 128^2 level on one block); mg_vcycle.cu takes a
# cluster of CORE_CTAS blocks or one block
CORE_CTAS = 8
CLUSTER_N = 64

# ghost-fill kinds of the kernel (mg_vcycle.cu: COPY, NEGATE, PERIODIC)
BC_KIND = {"outflow": 0, "neumann": 0, "reflect-even": 0,
           "dirichlet": 1, "reflect-odd": 1, "periodic": 2}
# and its fourth kind, ZERO: every ghost of the edge +0.0.  That is what
# the moving lid's fill writes at multigrid level, where MG._fill_v hands
# the registered function a stack whose one variable is "v", so its
# y-velocity branch writes 0.0 into the top ghosts for the u solve as for
# the v solve (solvers/incompressible_viscous/BC.py).  The constant
# operator's entries take it (the cavity's Crank-Nicolson solves); it is
# kept out of BC_KIND, which the sharded kernels take their kinds from:
# `edge_kinds` alone maps it
ZERO = 3

# the operators: entry-name suffix and coefficient planes per level
FLAVOURS = {"const": ("", 0), "vc": ("_vc", 2), "general": ("_general", 5)}

# floating-point operations, counted from mg_vcycle.cu (+, -, *, / and a
# negation each one), by operator
FLOPS_GS = {"const": 7, "vc": 13, "general": 17}     # one GS cell update
FLOPS_RESID = {"const": 13, "vc": 12, "general": 20}  # one residual cell
FLOPS_RESTRICT = 4    # one coarse cell of the average of four residuals
FLOPS_PROLONG = 9     # one fine cell of prolong and correct

launches = {f"mg_{e}{sfx}": 0 for sfx, _ in FLAVOURS.values()
            for e in ("core", "down", "up")}

_lib = None


class Ineligible(NotImplementedError):
    """This multigrid configuration is not covered by the CUDA kernels."""


def build(verbose=False):
    """Compile mg_vcycle.cu (if its library is not built yet); returns
    (library path, seconds spent in nvcc, nvcc's stderr)."""
    return cuda_build.build(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        so, _, _ = build()
        lib = ctypes.CDLL(str(so))
        ptr, i32, dbl = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        ints, doubles = ctypes.POINTER(i32), ctypes.POINTER(dbl)
        for sfx, ncoef in FLAVOURS.values():
            # bc, coef, ab, the core_plan or tile plan, then (coefficient
            # entries) the planes, stream
            for t in ("f32", "f64"):
                for kind, nptr, nint in (("core", 4, 3), ("down", 5, 2),
                                         ("up", 6, 2)):
                    tail = [ints, doubles, doubles, ints] + \
                        ([ptr] if ncoef else []) + [ptr]
                    fn = getattr(lib, f"mg_{kind}{sfx}_{t}")
                    fn.argtypes = [ptr] * nptr + [i32] * nint + tail
                    fn.restype = i32
        lib.mg_tile_plan_ints.restype = i32
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# eligibility and the level split
# ---------------------------------------------------------------------------

def flavour(mg):
    """The operator of an MG object: "const", "vc" or "general" (exact
    classes only: a subclass may change the operator)."""
    from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d
    from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d
    from pyro2_tpu_torch.multigrid.variable_coeff_MG import VarCoeffCCMG2d

    kinds = {CellCenterMG2d: "const", VarCoeffCCMG2d: "vc",
             GeneralMG2d: "general"}
    if type(mg) not in kinds:
        raise Ineligible(
            f"{type(mg).__name__} is none of the operators the multigrid "
            "kernels cover: CellCenterMG2d, VarCoeffCCMG2d and GeneralMG2d "
            "(ROADMAP.md A.10)")
    return kinds[type(mg)]


def edge_kinds(bc):
    """The kernels' ghost kinds of a level BC's edges x-lo, x-hi, y-lo,
    y-hi.  An extended kind is taken only as the moving lid on the top
    edge filled by the port's own incompressible_viscous.BC.user (the
    registry is a module-level dict that any caller may fill), as ZERO;
    anything else raises Ineligible."""
    from pyro2_tpu_torch.solvers.incompressible_viscous import BC

    kinds = []
    for edge in ("xlb", "xrb", "ylb", "yrb"):
        kind = getattr(bc, edge)
        if kind in BC_KIND and kind not in bnd.ext_bcs:
            kinds.append(BC_KIND[kind])
        elif (kind == "moving_lid" and edge == "yrb" and
              bnd.ext_bcs.get(kind) is BC.user):
            kinds.append(ZERO)
        else:
            raise Ineligible(
                f"the extended multigrid BC '{kind}' on {edge} waits for a "
                "later slice of the port (ROADMAP.md A.26): the kernels "
                "take the moving lid of incompressible_viscous.BC on yrb "
                "only")
    return kinds


def check(mg):
    """The operator's flavour (see `flavour`); raises Ineligible unless
    the kernels cover this MG configuration."""
    op = flavour(mg)
    if mg.ng != 1 or mg.nx != mg.ny or mg.nx & (mg.nx - 1):
        raise Ineligible("the multigrid kernels take ng=1 on a square "
                         "power-of-2 grid")
    for bc in mg.bc_v:
        if ZERO in edge_kinds(bc) and op != "const":
            raise Ineligible(
                "the moving lid's ZERO edge is taken by the constant "
                "operator's kernels only (ROADMAP.md A.26)")
    return op


def split(mg, dtype):
    """(top level of the core, peeled levels coarse to fine)."""
    top = mg.nlevels - 1
    while 2 ** (top + 1) > CORE_MAX[dtype]:
        top -= 1
    return top, list(range(top + 1, mg.nlevels))


def core_cells(level):
    """Interior cells a side of core level `level` (2x2 at level 0)."""
    return 2 << level


def core_cluster(top):
    """(CTAs of the core's cluster, first level spread over them): the
    levels of at least CLUSTER_N cells a side, when the top is one of them
    (each spread level then has 2 or more rows a CTA); else (1, top + 1),
    one block and no spread level."""
    ctas, first = CORE_CTAS, top + 1
    while first > 0 and core_cells(first - 1) >= max(CLUSTER_N, 2 * ctas):
        first -= 1
    return (ctas, first) if first <= top and ctas > 1 else (1, top + 1)


def core_schedule(top):
    """The warps of each core level 0..top: the power of 2 that gives each
    lane at least one cell of a colour in a half-sweep (a spread level: of
    its rows on one CTA), from one warp up to the block's 32, and never
    fewer than the coarser level's, so each level below the spread ones
    runs on a prefix of its finer neighbour's warps (mg_vcycle.cu's nested
    barriers).  The block is the top's warps; the spread levels run on all
    of them."""
    ctas, first = core_cluster(top)
    warps = []
    for level in range(top + 1):
        colour = core_cells(level) ** 2 // 2
        if level >= first:
            colour //= ctas
        w = warps[-1] if warps else 1
        while w < CORE_WARPS and 32 * w < colour:
            w *= 2
        warps.append(w)
    return warps


def core_offsets(top):
    """The core's shared-memory layout for levels 0..top, in elements of
    the dtype: where v of each level starts (its f follows it), coarsest
    first, then where the layout ends."""
    off = [0]
    for level in range(top + 1):
        off.append(off[-1] + 2 * (core_cells(level) + 2) ** 2)
    return off


def core_plan(top):
    """The schedule array the core entries take: the warps of each level
    (core_schedule), the cluster (core_cluster) and the shared-memory
    layout (core_offsets)."""
    return core_schedule(top) + list(core_cluster(top)) + core_offsets(top)


# ---------------------------------------------------------------------------
# the plans of mg_down's and mg_up's tiles
# ---------------------------------------------------------------------------

# the tiled kernels' block: rows of 32 threads (mg_vcycle.cu TILE_X), at
# most TILE_THREADS
TILE_THREADS = 512
# the owned tile's side: the largest power of 2 up to TILE_MAX that still
# gives TILE_BLOCKS tiles or more and whose box holds a halo for all
# nsmooth iterations, and not below TILE_MIN (nor above the level): a
# larger tile recomputes less of its halo, more tiles fill more SMs.  The
# descent and the ascent take the same tiles: fewer, larger ones were no
# faster at any level on the card (chip_smoke.py times mg_down with them)
TILE_MAX, TILE_MIN, TILE_BLOCKS = 64, 16, 128
# the most bytes a tile's boxes (v and f) may take, so that two blocks
# share an SM
TILE_SMEM = 110 * 1024


class TilePlan:
    """The tiling of one mg_down or mg_up call on an n^2 level: the owned
    tile's side, the halo (one cell per half-sweep of a round, and one for
    the residual), the rounds of sweeps (separate launches, each on the
    last one's output) and the iterations of a full round, the block's
    threads, its shared memory (bytes: the boxes of v and f, each the tile
    and its halo) and the tiles along a side.  `blocks` is the least count
    of tiles the tile side keeps while it can (TILE_BLOCKS; others for
    measuring other tiles).  `ints()` is the array the kernels take."""

    FIELDS = ("tile", "halo", "rounds", "iters", "threads", "smem", "tiles")

    def __init__(self, n, nsmooth, dtype, blocks=TILE_BLOCKS):
        item = torch.empty((), dtype=dtype).element_size()
        side = math.isqrt(TILE_SMEM // (2 * item))  # the widest box that fits

        def most(tile):                 # iterations a round's box holds
            return (side - tile - 2) // 4         # tile + 2 (2 iters + 1)

        tile = min(n, TILE_MAX)
        while tile > TILE_MIN and ((n // tile) ** 2 < blocks or
                                   most(tile) < nsmooth):
            tile //= 2
        if nsmooth == 0:
            rounds, iters = 1, 0
        else:
            rounds = -(-nsmooth // min(most(tile), nsmooth))
            iters = -(-nsmooth // rounds)         # the rounds balanced
        self.nsmooth = nsmooth
        self.tile, self.iters, self.rounds = tile, iters, rounds
        self.halo = 2 * iters + 1
        self.threads = TILE_THREADS
        self.tiles = n // tile
        self.smem = 2 * (tile + 2 * self.halo) ** 2 * item

    def round_iters(self):
        """The iterations of each round: a full round's, the last the
        rest."""
        return [min(self.iters, self.nsmooth - k * self.iters)
                for k in range(self.rounds)]

    def ints(self):
        return [getattr(self, f) for f in self.FIELDS]


@functools.lru_cache(maxsize=128)
def tile_plan(n, nsmooth, dtype):
    """The plan of one mg_down or mg_up call (see TilePlan), made once for
    each set of arguments."""
    return TilePlan(n, nsmooth, dtype)


def _coef(mg, level):
    """xc, yc, den, dx^2, dy^2 of one level, as the plain smoother and
    residual compute them."""
    g = mg.grids[level]
    xc = mg.beta / g.dx ** 2
    yc = mg.beta / g.dy ** 2
    return [xc, yc, mg.alpha + 2.0 * xc + 2.0 * yc, g.dx ** 2, g.dy ** 2]


def _c_args(mg, op, levels):
    """(bc kinds, per-level coefficients, alpha and beta) as C arrays; the
    coefficient operators' scalars are unused (zeros)."""
    kinds = edge_kinds(mg.bc_v[-1])
    if op == "const":
        coef = [c for lv in levels for c in _coef(mg, lv)]
    else:
        coef = [0.0] * (5 * len(levels))
    return [(ctypes.c_int * 4)(*kinds),
            (ctypes.c_double * len(coef))(*coef),
            (ctypes.c_double * 2)(mg.alpha, mg.beta)]


def _planes(mg, op, level, dtype):
    """The data pointer of a level's coefficient plane stack, checked."""
    stack = mg.planes[level]
    g = mg.grids[level]
    ncoef = FLAVOURS[op][1]
    if (stack.device.type != "cuda" or stack.dtype != dtype or
            tuple(stack.shape) != (ncoef, g.qx, g.qy) or
            not stack.is_contiguous()):
        raise ValueError(f"level {level}'s coefficient planes are not a "
                         f"contiguous CUDA ({ncoef}, {g.qx}, {g.qy}) stack "
                         f"of {dtype}")
    return stack.data_ptr()


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def core_plain(mg, top, v, f, want_r):
    """(v, r or None): the V-cycle of levels 0..top; v None is a zero
    guess."""
    if v is None:
        v = torch.zeros_like(f)
    v = mg._v_cycle(top, v, f)
    return v, mg._residual(top, v, f) if want_r else None


def down_plain(mg, level, v, f):
    """(smoothed v, restricted residual) of one level; v None is a zero
    guess."""
    if v is None:
        v = torch.zeros_like(f)
    v = mg._smooth_n(level, v, f, mg.nsmooth)
    r = mg._residual(level, v, f)
    return v, restrict_array(r, mg.grids[level], mg.grids[level - 1])


def up_plain(mg, level, v, f, vc, want_r):
    """(v, r or None): prolong and add the coarse correction vc, fill the
    ghosts, post-smooth, and the residual if asked."""
    e = prolong_array(vc, mg.grids[level - 1], mg.grids[level])
    v = mg._fill_v(level, v + e)           # e's ghosts are zero
    v = mg._smooth_n(level, v, f, mg.nsmooth)
    return v, mg._residual(level, v, f) if want_r else None


# ---------------------------------------------------------------------------
# the kernel launches
# ---------------------------------------------------------------------------

def _check_tensors(mg, level, *tensors):
    g = mg.grids[level]
    for a in tensors:
        if a is None:
            continue
        if a.device.type != "cuda":
            raise ValueError("the multigrid kernels take CUDA tensors")
        if a.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"unsupported dtype {a.dtype}")
        if tuple(a.shape) != (g.qx, g.qy) or not a.is_contiguous():
            raise ValueError(f"expected a contiguous ({g.qx}, {g.qy}) frame, "
                             f"got {tuple(a.shape)}")


def _ptr(a):
    return None if a is None else a.data_ptr()


def _c_plan(plan):
    """A TilePlan's ints as the C array the tiled entries take."""
    if _load().mg_tile_plan_ints() != len(TilePlan.FIELDS):
        raise RuntimeError("mg_vcycle.cu takes another tile plan layout")
    ints = plan.ints()
    return (ctypes.c_int * len(ints))(*ints)


def _run(fn, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"multigrid kernel launch failed: CUDA error "
                           f"{err}")


def _entry(mg, kind, level_args, dtype, *, levels):
    """(library function, launch-count key, operator arguments) of a
    kernel entry for this MG's operator."""
    op = check(mg)
    sfx = FLAVOURS[op][0]
    t = "f32" if dtype == torch.float32 else "f64"
    fn = getattr(_load(), f"mg_{kind}{sfx}_{t}")
    args = _c_args(mg, op, levels)
    if op != "const":
        ptrs = [_planes(mg, op, lv, dtype) for lv in levels]
        args.append((ctypes.c_void_p * len(ptrs))(*ptrs)
                    if kind == "core" else ptrs[0])
    return fn, f"mg_{kind}{sfx}", level_args + args


def launch_core(mg, top, v, f, want_r):
    """The CUDA core kernel: (v, r or None) of levels 0..top."""
    _check_tensors(mg, top, v, f)
    vo = torch.empty_like(f)
    r = torch.empty_like(f) if want_r else None
    fn, key, args = _entry(mg, "core", [top, mg.nsmooth, mg.nsmooth_bottom],
                           f.dtype, levels=list(range(top + 1)))
    schedule = core_plan(top)
    args.insert(6, (ctypes.c_int * len(schedule))(*schedule))
    _run(fn, f.device, _ptr(v), _ptr(f), _ptr(vo), _ptr(r), *args)
    launches[key] += 1
    return vo, r


def launch_down(mg, level, v, f, plan=None):
    """The CUDA down kernel: (smoothed v, coarse f), with tile_plan's tiles
    unless another TilePlan is given (for measuring other tiles)."""
    _check_tensors(mg, level, v, f)
    gc = mg.grids[level - 1]
    n = mg.grids[level].nx
    plan = plan or tile_plan(n, mg.nsmooth, f.dtype)
    vo = torch.empty_like(f)
    fc = torch.empty((gc.qx, gc.qy), dtype=f.dtype, device=f.device)
    scratch = torch.empty_like(f) if plan.rounds > 1 else None
    fn, key, args = _entry(mg, "down", [n, mg.nsmooth], f.dtype,
                           levels=[level])
    args.insert(5, _c_plan(plan))
    _run(fn, f.device, _ptr(v), _ptr(f), _ptr(vo), _ptr(fc), _ptr(scratch),
         *args)
    launches[key] += 1
    return vo, fc


def launch_up(mg, level, v, f, vc, want_r):
    """The CUDA up kernel: (v, r or None)."""
    _check_tensors(mg, level, v, f)
    _check_tensors(mg, level - 1, vc)
    n = mg.grids[level].nx
    plan = tile_plan(n, mg.nsmooth, f.dtype)
    vo = torch.empty_like(f)
    r = torch.empty_like(f) if want_r else None
    scratch = torch.empty_like(f) if plan.rounds > 1 else None
    fn, key, args = _entry(mg, "up", [n, mg.nsmooth], f.dtype,
                           levels=[level])
    args.insert(5, _c_plan(plan))
    _run(fn, f.device, _ptr(v), _ptr(f), _ptr(vc), _ptr(vo), _ptr(r),
         _ptr(scratch), *args)
    launches[key] += 1
    return vo, r


# ---------------------------------------------------------------------------
# the entries: the kernel for CUDA tensors, the plain version on the CPU
# ---------------------------------------------------------------------------

def core(mg, top, v, f, want_r):
    if f.device.type == "cpu":
        return core_plain(mg, top, v, f, want_r)
    return launch_core(mg, top, v, f, want_r)


def down(mg, level, v, f):
    if f.device.type == "cpu":
        return down_plain(mg, level, v, f)
    return launch_down(mg, level, v, f)


def up(mg, level, v, f, vc, want_r):
    if f.device.type == "cpu":
        return up_plain(mg, level, v, f, vc, want_r)
    return launch_up(mg, level, v, f, vc, want_r)


def has_values(bc):
    """Whether a BC carries inhomogeneous edge values."""
    return any(val is not None for val in (bc.xl_value, bc.xr_value,
                                           bc.yl_value, bc.yr_value))


def lifted_rhs(mg, f):
    """The finest level's right-hand side under homogeneous ghost fills
    that gives the solve of f under the BC values of mg.bc_v[-1].

    Each fill that reads a value is affine, ghost = s (mirrored interior
    cell) + o, with s the sign of the homogeneous fill of the same kind
    (dirichlet and reflect-odd: s = -1, o = 2 value; outflow and neumann:
    s = +1, o = -/+ dx value).  The operator is linear, so with g the frame
    of zero interior and ghosts o, A(v) = A_h(v) + A(g), and the solve of
    A(v) = f is the homogeneous solve of A_h(v) = f - A(g).  The fill of a
    zero frame is g, and the MG's own residual of g against a zero f is
    -A(g)."""
    fine = mg.nlevels - 1
    zero = torch.zeros_like(f)
    g = fill_ghost(zero.clone(), mg.grids[fine], mg.bc_v[-1])
    return f + mg._residual(fine, g, zero)


def _homogeneous(mg):
    """A shallow copy of mg whose finest level fills its ghosts without
    the BC values (the BC of the coarse levels)."""
    m = copy.copy(mg)
    m.bc_v = mg.bc_v[:-1] + [mg.bc]
    return m


def kernel_rhs(mg, f):
    """The right-hand side `cycle` hands the finest level's entries in
    place of f: lifted_rhs(mg, f) under BC values on CUDA, else None (f
    itself)."""
    if f.device.type == "cpu" or not has_values(mg.bc_v[-1]):
        return None
    return lifted_rhs(mg, f)


def cycle(mg, v, f, f_h=None):
    """One V-cycle of the finest level: (v, r), downs -> core -> ups.

    Under BC values on CUDA the entries take the lifted right-hand side
    f_h (`kernel_rhs`, computed here unless the caller passes it, as a
    solve does once for all its cycles) with homogeneous fills, and the
    finest level's ghosts are refilled with the values after.  A CPU
    caller that passes f_h runs the same formulation on the plain
    versions; without it the CPU cycle fills the values in place."""
    if f_h is None:
        f_h = kernel_rhs(mg, f)
    if f_h is None:
        return _cycle(mg, v, f)
    v, r = _cycle(_homogeneous(mg), v, f_h)
    return mg._fill_v(mg.nlevels - 1, v), r


def _cycle(mg, v, f):
    top, peeled = split(mg, f.dtype)
    fine = mg.nlevels - 1
    stack = []
    for lv in reversed(peeled):                  # fine -> coarse
        v, fc = down(mg, lv, v, f)
        stack.append((lv, v, f))
        v, f = None, fc                          # zero coarse guess
    v, r = core(mg, top, v, f, want_r=not peeled)
    for lv, v_lv, f_lv in reversed(stack):       # coarse -> fine
        v, r_lv = up(mg, lv, v_lv, f_lv, v, want_r=lv == fine)
        if lv == fine:
            r = r_lv
    return v, r


# ---------------------------------------------------------------------------
# the least work of each entry
# ---------------------------------------------------------------------------

def work(entry, n, nsmooth, dtype, *, nsmooth_bottom=50, with_guess=True,
         want_r=True):
    """(bytes, operations) one call must move and do at least, for a level
    of n^2 interior cells (the core's top level for a core entry): each
    input frame and coefficient plane read once and each output frame
    written once, and the operations of the sweeps, residuals and
    transfers counted from mg_vcycle.cu.  `entry` is a key of `launches`
    (mg_down, mg_up_vc, mg_core_general, ...)."""
    kind, _, sfx = entry.partition("_")[2].partition("_")
    op = {"": "const", "vc": "vc", "general": "general"}.get(sfx)
    if not entry.startswith("mg_") or op is None:
        raise ValueError(f"unknown entry {entry}")
    ncoef = FLAVOURS[op][1]
    gs, res = FLOPS_GS[op], FLOPS_RESID[op]
    item = torch.empty((), dtype=dtype).element_size()
    q2 = (n + 2) ** 2
    qc2 = (n // 2 + 2) ** 2
    if kind == "down":
        frames = (2 if with_guess else 1) * q2 + q2 + qc2 + ncoef * q2
        ops = (gs * nsmooth + res) * n * n + FLOPS_RESTRICT * (n // 2) ** 2
    elif kind == "up":
        frames = 3 * q2 + qc2 + (q2 if want_r else 0) + ncoef * q2
        ops = (FLOPS_PROLONG + gs * nsmooth + (res if want_r else 0)) * n * n
    elif kind == "core":
        frames = (2 if with_guess else 1) * q2 + q2 + (q2 if want_r else 0)
        ops = gs * nsmooth_bottom * 4 + (res * n * n if want_r else 0)
        m = n
        while m > 2:
            ops += (2 * gs * nsmooth + res + FLOPS_PROLONG) * m * m + \
                FLOPS_RESTRICT * (m // 2) ** 2
            m //= 2
        m = n
        while m >= 2:                          # every core level's planes
            frames += ncoef * (m + 2) ** 2
            m //= 2
    else:
        raise ValueError(f"unknown entry {entry}")
    return frames * item, ops
