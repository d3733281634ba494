"""The wrapper of the CUDA swe step kernel (pyro2_tpu_torch/csrc/swe_step.cu).

The kernel is the counterpart of the JAX package's fused Pallas step
(pyro2_tpu/solvers/swe/pallas_step.py::make_pallas_swe_step_padded).  It is
built with nvcc into a shared library under pyro2_tpu_torch/_build/ at
first use (pyro2_tpu_torch.util.cuda_build) and bound with ctypes.  A step
is one launch: each block computes one output tile out of shared memory,
and `plan` -- the tile, the halos each phase reads and the block's
shared-memory layout -- is worked out here and handed to the kernel, so the
CPU tests check it.

`SWEStep(sim)(U, t, dt)` is the step the Simulation evolves with:

  * for a CUDA tensor it launches the kernel (or raises: there is no
    fallback), counting the launch in the module-level `launches`: the
    host-dt entry `swe_step_*` for a float dt, the device-dt entry
    `swe_step_dev_*` for a 0-d tensor dt of the state's dtype on its device
    (the on-device loop's, driver_loop.py: a CUDA graph replays it with the
    dt it computed);
  * for a CPU tensor it runs the plain PyTorch step, `sim._make_step()`.

The kernel updates the interior and carries the input's ghost cells through
unchanged; `fill_BC_all` refills them before the next step.  Ghost fills and
the CFL timestep stay plain PyTorch, as they were plain JAX outside the
Pallas kernel.
"""

import ctypes
import functools

import torch

from pyro2_tpu_torch.solvers.swe.unsplit_fluxes import (SWE_ITEM,
                                                        check_flattening)
from pyro2_tpu_torch.util import cuda_build

__all__ = ["SWEStep", "Plan", "build", "covered", "launches", "plan", "work",
           "flops_per_zone", "HALO", "TILES"]

SOURCE = cuda_build.CSRC / "swe_step.cu"

MAXVAR = cuda_build.MAXVAR
RIEMANN = {"Roe": 0, "HLLC": 1}

# floating-point operations of one interface's Riemann solve, counted from
# swe_step.cu (+, -, *, /, sqrt each one operation): Roe without the
# entropy fix's rewrite, HLLC with its star state (the subsonic faces)
RIEMANN_FLOPS = {"Roe": 111, "HLLC": 72}

# per zone of one step, for the main path's configuration (limiter 2,
# nvar 4), besides the four Riemann solves (an x and a y interface in each
# of the two passes)
FLOPS_PER_ZONE_BY_STAGE = {
    "prim": 3,          # cons -> prim with the h == 0 guard
    "states": 352,      # 4th-order MC slopes, tracing, prim -> cons, x and y
    "transverse": 48,   # the corrections of the second pass's states
    "update": 24,       # conservative update
}


def flops_per_zone(riemann):
    """Operations per zone of one step with the given Riemann solver."""
    return sum(FLOPS_PER_ZONE_BY_STAGE.values()) + 4 * RIEMANN_FLOPS[riemann]


launches = 0   # kernel launches made through SWEStep (read by chip_smoke.py)

# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

# the output tile of a block, (rows along x, columns along y), by dtype:
# the first of these whose block leaves room in an SM's shared memory for
# BLOCKS of them.  In float32 a 30 x 30 tile (32 x 32 traced cells, two for
# each of the block's 512 threads) up to 4 variables, else 14 x 30 (16 x
# 32, one a thread); in float64 14 x 14 on 256 threads (swe_step.cu's
# SweLaunch).  The larger tile recomputes fewer halo cells, and was the
# fastest on the card (chip_smoke.py times the step with other tiles)
TILES = {torch.float32: ((30, 30), (14, 30)), torch.float64: ((14, 14),)}
THREADS = {torch.float32: 512, torch.float64: 256}
BLOCKS = {torch.float32: 2, torch.float64: 1}

# how far beyond the output tile each box of a block reaches (swe_step.cu's
# phases): the traced cells (the states of the faces whose first-pass
# fluxes the tile's transverse corrections read) and the primitives (the
# 4th-order MC slope of a traced cell reads two cells along each axis)
HALO = {"traced": 1, "prim": 3}

# the shared memory one block may opt into on the H100, and an SM's, which
# its blocks share
SMEM_LIMIT = 232448
SMEM_SM = 233472


class Plan:
    """One launch's tiling: the tile (tx rows, ty columns), the block's
    threads, the grid of tiles (blocks along y, along x) the launch takes,
    and the block's shared memory: `offsets` of each array in elements of
    the dtype, `smem` in bytes.  The first Riemann pair ("f1") lies over the
    primitives ("q"), which no phase reads once the states are traced.
    `ints()` is the array the kernel takes.  `tile` replaces the choice from
    TILES (for measuring other tiles)."""

    ARRAYS = ("q", "st", "f1")

    def __init__(self, nx, ny, nvar, dtype, tile=None):
        self.nx, self.ny, self.nvar = nx, ny, nvar
        self.threads = THREADS[dtype]
        for self.tx, self.ty in [tile] if tile else TILES[dtype]:
            self._layout(nvar, dtype)
            if BLOCKS[dtype] * self.smem <= SMEM_SM:
                break

    def _layout(self, nvar, dtype):
        """The grid and the shared memory of the tile (tx, ty)."""
        self.halo = dict(HALO)
        self.grid = (-(-self.ny // self.ty), -(-self.nx // self.tx))
        item = torch.empty((), dtype=dtype).element_size()
        traced = self.box("traced")
        self.sizes = {
            "q": nvar * self.box("prim"),   # the primitives
            "st": 4 * nvar * traced,        # each traced cell's four states
            "f1": 2 * nvar * traced,        # the first pair, x and y faces
        }
        self.offsets = {"st": 0, "q": self.sizes["st"], "f1": self.sizes["st"]}
        self.smem = (self.sizes["st"] + max(self.sizes["q"],
                                            self.sizes["f1"])) * item

    def box(self, name):
        """Cells of a block's box: the tile and its halo."""
        h = self.halo[name]
        return (self.tx + 2 * h) * (self.ty + 2 * h)

    def ints(self):
        h = self.halo
        return [self.tx, self.ty, self.threads, h["prim"], h["traced"],
                *(self.offsets[a] for a in self.ARRAYS), self.smem,
                *self.grid]


@functools.lru_cache(maxsize=64)
def plan(nx, ny, nvar, dtype, tile=None):
    """The launch plan of one step (see Plan), made once for each set of
    arguments."""
    return Plan(nx, ny, nvar, dtype, tile)


def covered(nvar, ng, dtype):
    """Raise NotImplementedError unless the fused kernel takes this frame:
    4..MAXVAR variables, ghosts as deep as the primitives' halo, and a
    block whose boxes fit the shared memory a block may opt into."""
    if not 4 <= nvar <= MAXVAR:
        raise NotImplementedError(
            f"the swe kernel takes 4..{MAXVAR} variables, not {nvar} "
            "(ROADMAP.md A.23)")
    if ng < HALO["prim"]:
        raise NotImplementedError(
            f"the swe kernel takes {HALO['prim']} or more ghost cells, not "
            f"{ng} (ROADMAP.md A.23)")
    smem = plan(1, 1, nvar, dtype).smem
    if smem > SMEM_LIMIT:
        raise NotImplementedError(
            f"the swe kernel's boxes take {smem} B of shared memory, more "
            f"than a block's {SMEM_LIMIT} (ROADMAP.md A.23)")


def _c_ints(values):
    return (ctypes.c_int * len(values))(*values)


_lib = None


def build(verbose=False):
    """Compile swe_step.cu (if its library is not built yet).

    Returns (library path, seconds spent in nvcc, nvcc's stderr).  With
    verbose=True ptxas reports registers, shared memory and spills."""
    return cuda_build.build(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        so, _, _ = build()
        lib = ctypes.CDLL(str(so))
        ints = ctypes.POINTER(ctypes.c_int)
        for name in ("swe_step_f32", "swe_step_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 2 + [
                ints, ctypes.POINTER(ctypes.c_double), ints, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ("swe_step_dev_f32", "swe_step_dev_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 2 + [
                ints, ctypes.POINTER(ctypes.c_double), ints,
                ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.swe_plan_ints.restype = ctypes.c_int
        if lib.swe_plan_ints() != len(Plan.ARRAYS) + 8:
            raise RuntimeError("swe_step.cu takes another plan layout")
        _lib = lib
    return _lib


def work(nx, ny, nvar, dtype, riemann):
    """(bytes, operations) one step must move and do at least: the state
    read once and written once, and flops_per_zone per interior zone."""
    item = torch.empty((), dtype=dtype).element_size()
    return (2 * nvar * (nx + 8) * (ny + 8) * item,
            flops_per_zone(riemann) * nx * ny)


class SWEStep:
    """step(U, t, dt) -> U_new for a live swe Simulation (whose Variables
    put height and the momenta at 0, 1 and 2, as the kernel assumes)."""

    def __init__(self, sim):
        rp = sim.rp
        myg = sim.cc_data.grid
        ivars = sim.ivars
        check_flattening(rp)
        if not 4 <= ivars.nvar <= MAXVAR:
            raise NotImplementedError(
                f"the swe kernel takes 4..{MAXVAR} variables, not "
                f"{ivars.nvar} (ROADMAP.md, {SWE_ITEM})")
        method = rp.get_param("swe.riemann")
        if method not in RIEMANN:
            raise ValueError(f"unknown Riemann solver {method}")

        self.sim = sim
        self.plain = sim._make_step()
        self.method = method
        self.shape = (ivars.nvar, myg.qx, myg.qy)
        self._ints = [ivars.nvar, myg.nx, myg.ny, myg.ng, RIEMANN[method],
                      rp.get_param("swe.limiter")]
        self._doubles = [myg.dx, myg.dy, 0.0,  # dt, set per call
                         rp.get_param("swe.grav")]

    def check(self, U):
        """Raise on anything the kernel and its plain version do not take."""
        if not isinstance(U, torch.Tensor):
            raise TypeError("the swe step takes a torch.Tensor")
        if U.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {U.device}")
        if U.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"unsupported dtype {U.dtype}")
        if tuple(U.shape) != self.shape:
            raise ValueError(f"state shape {tuple(U.shape)} is not "
                             f"{self.shape}")
        if not U.is_contiguous():
            raise ValueError("the state must be contiguous")

    def __call__(self, U, t, dt):
        self.check(U)
        if U.device.type == "cpu":
            return self.plain(U, t, dt)
        return self.launch(U, t, dt)

    def launch(self, U, t, dt, tile=None):
        """Launch the CUDA kernel on U's device and current stream (with
        another tile than the plan's if one is given): the host-dt entry
        for a float dt, the device-dt entry for a 0-d tensor of U's dtype
        on its device."""
        global launches
        del t   # no time-dependent terms in swe
        self.check(U)
        if U.device.type != "cuda":
            raise ValueError("the CUDA swe kernel takes a CUDA tensor")
        on_device = isinstance(dt, torch.Tensor)
        if on_device and (dt.shape != () or dt.dtype != U.dtype or
                          dt.device != U.device):
            raise ValueError("a device dt is a 0-d tensor of the state's "
                             "dtype on its device")
        nvar = self.shape[0]
        covered(nvar, self._ints[3], U.dtype)
        doubles = list(self._doubles)
        if not on_device:
            doubles[2] = float(dt)

        lib = _load()
        tiles = plan(self._ints[1], self._ints[2], nvar, U.dtype, tile)
        out = torch.empty_like(U)
        sfx = "f32" if U.dtype == torch.float32 else "f64"
        args = (U.data_ptr(), out.data_ptr(), _c_ints(self._ints),
                (ctypes.c_double * len(doubles))(*doubles),
                _c_ints(tiles.ints()))
        with torch.cuda.device(U.device):
            stream = torch.cuda.current_stream(U.device).cuda_stream
            if on_device:
                err = getattr(lib, f"swe_step_dev_{sfx}")(
                    *args, dt.data_ptr(), stream)
            else:
                err = getattr(lib, f"swe_step_{sfx}")(*args, stream)
        if err != 0:
            raise RuntimeError(f"swe kernel launch failed: CUDA error {err}")
        launches += 1
        return out
