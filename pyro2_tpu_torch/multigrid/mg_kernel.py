"""The fused multigrid V-cycle on the H100 (pyro2_tpu_torch/csrc/mg_vcycle.cu)
and its plain PyTorch version.

The counterpart of pyro2_tpu/multigrid/pallas_mg.py.  A cycle of
CellCenterMG2d runs as `downs -> core -> ups`, the assembly of the JAX
package's `build_fused_cycle`:

  * `core` runs the whole sub-V-cycle of levels 0..top in one kernel (one
    thread block, the level frames in shared memory), and writes the
    residual when no level is peeled;
  * each finer, peeled level adds one `down` (pre-smooth, residual,
    restrict) and one `up` (prolong and correct, post-smooth, and the
    residual on the finest level), each one cooperative launch.

One cycle launches 1 core and 1 down plus 1 up per peeled level, as the
TPU's did.  Which levels the core holds is a property of the card's shared
memory, not of the TPU's VMEM: `CORE_MAX` below.  The TPU's row-banded
kernels for levels above 512^2 have no counterpart: `down` and `up` take a
level of any size.

For a CUDA tensor each entry launches its kernel, counting the launch in
`launches`, or raises; for a CPU tensor it runs its plain version
(`core_plain`, `down_plain`, `up_plain`, composed from CellCenterMG2d's
smoother and residual and mesh.patch's restrict and prolong).  There is no
fallback from one to the other.  The kernels take plain CellCenterMG2d with
ng=1 on a square power-of-2 grid and homogeneous standard BCs; anything
else raises `Ineligible` (a NotImplementedError) on CUDA, naming its
ROADMAP item.
"""

import ctypes

import torch

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.mesh.patch import prolong_array, restrict_array
from pyro2_tpu_torch.util import cuda_build

__all__ = ["CORE_MAX", "Ineligible", "build", "check", "core", "core_plain",
           "cycle", "down", "down_plain", "launches", "split", "up",
           "up_plain", "work"]

SOURCE = cuda_build.CSRC / "mg_vcycle.cu"

# finest level run inside the single-block core kernel, by dtype: v and f of
# every core level must fit in the 227 KB of shared memory a block may use
# (levels 2^2..128^2 in float32: 183 KB; 2^2..64^2 in float64: 96 KB)
CORE_MAX = {torch.float32: 128, torch.float64: 64}

# ghost-fill kinds of the kernel (mg_vcycle.cu: COPY, NEGATE, PERIODIC)
BC_KIND = {"outflow": 0, "neumann": 0, "reflect-even": 0,
           "dirichlet": 1, "reflect-odd": 1, "periodic": 2}

# floating-point operations, counted from mg_vcycle.cu (+, -, *, / each one)
FLOPS_GS = 7          # one Gauss-Seidel cell update
FLOPS_RESID = 13      # one residual cell
FLOPS_RESTRICT = 4    # one coarse cell of the average of four residuals
FLOPS_PROLONG = 9     # one fine cell of prolong and correct

launches = {"mg_core": 0, "mg_down": 0, "mg_up": 0}

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
        for t in ("f32", "f64"):
            fn = getattr(lib, f"mg_core_{t}")
            fn.argtypes = [ptr] * 4 + [i32] * 3 + [ints, doubles, doubles,
                                                   ptr]
            fn.restype = i32
            fn = getattr(lib, f"mg_down_{t}")
            fn.argtypes = [ptr] * 4 + [i32] * 2 + [ints, doubles, doubles,
                                                   ptr]
            fn.restype = i32
            fn = getattr(lib, f"mg_up_{t}")
            fn.argtypes = [ptr] * 5 + [i32] * 2 + [ints, doubles, doubles,
                                                   ptr]
            fn.restype = i32
        lib.mg_core_smem.argtypes = [i32, i32]
        lib.mg_core_smem.restype = ctypes.c_size_t
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# eligibility and the level split
# ---------------------------------------------------------------------------

def check(mg):
    """Raise Ineligible unless the kernels cover this MG configuration."""
    from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d

    if type(mg) is not CellCenterMG2d:
        raise Ineligible(
            "coefficient multigrid waits for a later slice of the port "
            "(ROADMAP.md A.10 and B4)")
    if mg.ng != 1 or mg.nx != mg.ny or mg.nx & (mg.nx - 1):
        raise Ineligible("the multigrid kernels take ng=1 on a square "
                         "power-of-2 grid")
    for bc in mg.bc_v:
        for edge in ("xlb", "xrb", "ylb", "yrb"):
            kind = getattr(bc, edge)
            if kind in bnd.ext_bcs or kind not in BC_KIND:
                raise Ineligible(
                    f"multigrid BC '{kind}' waits for a later slice of the "
                    "port (ROADMAP.md A.7, incompressible_viscous)")
        for val in (bc.xl_value, bc.xr_value, bc.yl_value, bc.yr_value):
            if val is not None:
                raise Ineligible(
                    "inhomogeneous multigrid BC values wait for a later "
                    "slice of the port (ROADMAP.md A.6)")


def split(mg, dtype):
    """(top level of the core, peeled levels coarse to fine)."""
    top = mg.nlevels - 1
    while 2 ** (top + 1) > CORE_MAX[dtype]:
        top -= 1
    return top, list(range(top + 1, mg.nlevels))


def _coef(mg, level):
    """xc, yc, den, dx^2, dy^2 of one level, as the plain smoother and
    residual compute them."""
    g = mg.grids[level]
    xc = mg.beta / g.dx ** 2
    yc = mg.beta / g.dy ** 2
    return [xc, yc, mg.alpha + 2.0 * xc + 2.0 * yc, g.dx ** 2, g.dy ** 2]


def _c_args(mg, levels):
    """(bc kinds, per-level coefficients, alpha and beta) as C arrays."""
    bc = mg.bc_v[-1]
    kinds = [BC_KIND[getattr(bc, e)] for e in ("xlb", "xrb", "ylb", "yrb")]
    coef = [c for lv in levels for c in _coef(mg, lv)]
    return ((ctypes.c_int * 4)(*kinds),
            (ctypes.c_double * len(coef))(*coef),
            (ctypes.c_double * 2)(mg.alpha, mg.beta))


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


def _run(fn, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"multigrid kernel launch failed: CUDA error "
                           f"{err}")


def launch_core(mg, top, v, f, want_r):
    """The CUDA core kernel: (v, r or None) of levels 0..top."""
    check(mg)
    _check_tensors(mg, top, v, f)
    lib = _load()
    vo = torch.empty_like(f)
    r = torch.empty_like(f) if want_r else None
    fn = lib.mg_core_f32 if f.dtype == torch.float32 else lib.mg_core_f64
    bc, coef, ab = _c_args(mg, range(top + 1))
    _run(fn, f.device, _ptr(v), _ptr(f), _ptr(vo), _ptr(r), top,
         mg.nsmooth, mg.nsmooth_bottom, bc, coef, ab)
    launches["mg_core"] += 1
    return vo, r


def launch_down(mg, level, v, f):
    """The CUDA down kernel: (smoothed v, coarse f)."""
    check(mg)
    _check_tensors(mg, level, v, f)
    lib = _load()
    gc = mg.grids[level - 1]
    vo = torch.empty_like(f)
    fc = torch.empty((gc.qx, gc.qy), dtype=f.dtype, device=f.device)
    fn = lib.mg_down_f32 if f.dtype == torch.float32 else lib.mg_down_f64
    bc, coef, ab = _c_args(mg, [level])
    _run(fn, f.device, _ptr(v), _ptr(f), _ptr(vo), _ptr(fc),
         mg.grids[level].nx, mg.nsmooth, bc, coef, ab)
    launches["mg_down"] += 1
    return vo, fc


def launch_up(mg, level, v, f, vc, want_r):
    """The CUDA up kernel: (v, r or None)."""
    check(mg)
    _check_tensors(mg, level, v, f)
    _check_tensors(mg, level - 1, vc)
    lib = _load()
    vo = torch.empty_like(f)
    r = torch.empty_like(f) if want_r else None
    fn = lib.mg_up_f32 if f.dtype == torch.float32 else lib.mg_up_f64
    bc, coef, ab = _c_args(mg, [level])
    _run(fn, f.device, _ptr(v), _ptr(f), _ptr(vc), _ptr(vo), _ptr(r),
         mg.grids[level].nx, mg.nsmooth, bc, coef, ab)
    launches["mg_up"] += 1
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


def cycle(mg, v, f):
    """One V-cycle of the finest level: (v, r), downs -> core -> ups."""
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
    of n^2 interior cells (the core's top level for "mg_core"): each input
    frame read once and each output frame written once, and the operations
    of the sweeps, residuals and transfers counted from mg_vcycle.cu."""
    item = torch.empty((), dtype=dtype).element_size()
    q2 = (n + 2) ** 2
    qc2 = (n // 2 + 2) ** 2
    if entry == "mg_down":
        frames = (2 if with_guess else 1) * q2 + q2 + qc2
        ops = (FLOPS_GS * nsmooth + FLOPS_RESID) * n * n + \
            FLOPS_RESTRICT * (n // 2) ** 2
    elif entry == "mg_up":
        frames = 3 * q2 + qc2 + (q2 if want_r else 0)
        ops = (FLOPS_PROLONG + FLOPS_GS * nsmooth +
               (FLOPS_RESID if want_r else 0)) * n * n
    elif entry == "mg_core":
        frames = (2 if with_guess else 1) * q2 + q2 + (q2 if want_r else 0)
        ops = FLOPS_GS * nsmooth_bottom * 4 + (FLOPS_RESID * n * n
                                               if want_r else 0)
        m = n
        while m > 2:
            ops += (2 * FLOPS_GS * nsmooth + FLOPS_RESID + FLOPS_PROLONG) * \
                m * m + FLOPS_RESTRICT * (m // 2) ** 2
            m //= 2
    else:
        raise ValueError(f"unknown entry {entry}")
    return frames * item, ops
