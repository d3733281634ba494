"""The wrapper of the CUDA lm_atm interface stages
(pyro2_tpu_torch/csrc/lm_interface.cu) and their plain PyTorch versions.

The counterpart of pyro2_tpu/solvers/lm_atm/pallas_interface.py
(LMInterfaceKernels).  `LMInterface(grid)` has its three entries, with the
signatures and output layouts of the JAX package's:

  * `mac_vels(dt, u, v, lux, lvx, luy, lvy, gpx, gpy, src)` -> the full
    padded (u_MAC, v_MAC) frames, zeros outside the (lo-1, hi+2) window;
  * `rho_increment(dt, rho, u_MAC, v_MAC, lrx, lry)` -> the (nx, ny)
    interior density increment -dt div(rho_int U_MAC);
  * `advect_terms(dt, u, v, lux, ..., src, u_MAC, v_MAC)` -> the (nx, ny)
    interior advective terms of u and v.

For a CUDA tensor each entry launches its kernel, one launch a call
counted in `launches` (lm_mac, lm_rho, lm_states), with the tiling of
`plan`, or raises; for a CPU tensor it runs its plain version
(`mac_vels_plain`, ...), the expressions of the JAX package's jnp path
(lm_atm/simulation.py) over LM_atm_interface.  There is no fallback from
one to the other.  The kernels take Cartesian grids with ng >= 4
(lm_atm's is 4) of any nx, ny.  The MC slopes come in as planes, computed
globally by mesh/reconstruction.limit.  A call allocates its outputs and
nothing else.
"""

import ctypes
import functools

import torch

from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.solvers.lm_atm import LM_atm_interface as lm_interface
from pyro2_tpu_torch.util import cuda_build

__all__ = ["ENTRIES", "LMInterface", "LmPlan", "advect_terms_plain",
           "build", "covered", "launches", "mac_vels_plain", "plan",
           "rho_increment_plain", "work"]

SOURCE = cuda_build.CSRC / "lm_interface.cu"

ENTRIES = ("lm_mac", "lm_rho", "lm_states")
launches = dict.fromkeys(ENTRIES, 0)

# floating-point operations, counted from lm_interface.cu (+, -, *, / each
# one): per cell of the (lo-1, hi+2) window, the first pass of the
# velocity stages ("hat") and of rho ("rho_hat"); per cell of that window,
# mac's two corrected faces ("mac"); per face, the final states of u and v
# ("face") or of rho ("rho_face"); per interior cell, the differences of
# the advective terms ("states") and of the increment ("rho")
FLOPS = {"hat": 42, "mac": 58, "rho_hat": 20, "face": 56, "rho_face": 30,
         "states": 18, "rho": 10}

# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

# the output tile of a block of each entry (rows along x, columns along
# y), the one lm_interface.cu compiles the entry's kernel for (LmTile):
# the fastest of the tiles and blocks timed on the H100 at bubble 1024^2
# in float32; its threads (LmLaunch), and the fewest blocks an SM holds,
# which bounds the registers a thread takes
TILES = {"lm_mac": (16, 32), "lm_rho": (16, 64), "lm_states": (8, 64)}
THREADS = 256
BLOCKS = {("lm_states", torch.float32): 4}

# what a block of each entry holds in shared memory: the input planes over
# the tile and its halo, the first-pass planes over the tile and a ring of
# RING cells (uhat, vhat and the four upwinded states; rho's two), and the
# face planes over the tile and one more row and column (the final u and
# v states on x and y faces; rho's)
PLANES = {"lm_mac": 9, "lm_rho": 5, "lm_states": 11}
FIRST = {"lm_mac": 6, "lm_rho": 2, "lm_states": 6}
FACES = {"lm_mac": 0, "lm_rho": 2, "lm_states": 4}

# how far the input boxes reach beyond the tile: a cell reads the first-pass
# values of the ring around it, and a first-pass value the inputs at (a-1,
# b), (a, b-1) and (a, b), so 2 cells below the tile and 1 above; rho's
# divergence corrections read the MAC velocity of the next face up, so 2
# above for rho
HALO = {"lo": 2, "hi": {"lm_mac": 1, "lm_rho": 2, "lm_states": 1}}
RING = 1
# the fewest ghost cells the kernels take: the input halo below the
# (lo-1, hi+2) window lies in the frame
NG_MIN = HALO["lo"] + 1

# the shared memory one block may opt into on the H100
SMEM_LIMIT = 232448


class LmPlan:
    """One launch's tiling for `entry` on an nx x ny grid with ng ghosts:
    the tile (tx rows, ty columns), the block's threads, the input halo
    below and above the tile (lo, hi), the offsets of the input, first-pass
    and face planes in the block's shared memory in elements of the dtype
    (in, fp, fc), its bytes (smem), and the grid of tiles (gx blocks along
    y, gy along x) over the outputs: the whole frame for lm_mac, the
    interior otherwise; `blocks` is how many the kernel is compiled to fit
    on an SM.  `ints()` is the array the kernel takes."""

    FIELDS = ("tx", "ty", "threads", "lo", "hi", "in", "fp", "fc", "smem",
              "gx", "gy")

    def __init__(self, entry, nx, ny, ng, dtype):
        item = torch.empty((), dtype=dtype).element_size()
        self.entry = entry
        self.threads = THREADS
        self.blocks = BLOCKS.get((entry, dtype), 2)
        self.lo, self.hi = HALO["lo"], HALO["hi"][entry]
        self.tx, self.ty = TILES[entry]
        self.sizes = {
            "in": PLANES[entry] * self.box("in"),
            "fp": FIRST[entry] * self.box("fp"),
            "fc": FACES[entry] * self.box("fc"),
        }
        self.offsets = {"in": 0, "fp": self.sizes["in"],
                        "fc": self.sizes["in"] + self.sizes["fp"]}
        self.smem = sum(self.sizes.values()) * item
        rows, cols = (nx + 2 * ng, ny + 2 * ng) if entry == "lm_mac" \
            else (nx, ny)
        self.origin = 0 if entry == "lm_mac" else ng
        self.gx, self.gy = -(-cols // self.ty), -(-rows // self.tx)

    def box(self, name):
        """Cells of a block's box: the inputs ("in"), the first pass
        ("fp") or the faces ("fc")."""
        extra = {"in": (self.lo + self.hi,) * 2, "fp": (2 * RING,) * 2,
                 "fc": (1, 1)}[name]
        return (self.tx + extra[0]) * (self.ty + extra[1])

    def ints(self):
        return [self.tx, self.ty, self.threads, self.lo, self.hi,
                self.offsets["in"], self.offsets["fp"], self.offsets["fc"],
                self.smem, self.gx, self.gy]


@functools.lru_cache(maxsize=64)
def plan(entry, nx, ny, ng, dtype):
    """The launch plan of one call (see LmPlan), made once for each set of
    arguments."""
    return LmPlan(entry, nx, ny, ng, dtype)


def covered(ng, dtype):
    """Raise NotImplementedError unless the tiled kernels take this frame:
    at least NG_MIN ghosts, and boxes that fit the shared memory a block
    may opt into."""
    if ng < NG_MIN:
        raise NotImplementedError(
            f"the lm_atm interface kernels take {NG_MIN} or more ghost "
            f"cells, not {ng} (ROADMAP.md A.25)")
    smem = max(plan(e, 1, 1, ng, dtype).smem for e in ENTRIES)
    if smem > SMEM_LIMIT:
        raise NotImplementedError(
            f"the lm_atm interface kernels' boxes take {smem} B of shared "
            f"memory, more than a block's {SMEM_LIMIT} (ROADMAP.md A.25)")


_lib = None


def build(verbose=False):
    """Compile lm_interface.cu (if its library is not built yet); returns
    (library path, seconds spent in nvcc, nvcc's stderr)."""
    return cuda_build.build(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        so, _, _ = build()
        lib = ctypes.CDLL(str(so))
        ptr = ctypes.c_void_p
        ints = ctypes.POINTER(ctypes.c_int)
        tail = [ints, ctypes.POINTER(ctypes.c_double), ints, ptr]
        for t in ("f32", "f64"):
            getattr(lib, f"lm_mac_{t}").argtypes = [ptr] * 3 + tail
            getattr(lib, f"lm_states_{t}").argtypes = [ptr] * 3 + tail
            getattr(lib, f"lm_rho_{t}").argtypes = [ptr] * 2 + tail
            for name in ENTRIES:
                getattr(lib, f"{name}_{t}").restype = ctypes.c_int
        lib.lm_plan_ints.restype = ctypes.c_int
        if lib.lm_plan_ints() != len(LmPlan.FIELDS):
            raise RuntimeError("lm_interface.cu takes another plan layout")
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# the plain versions: the JAX package's jnp-path expressions
# ---------------------------------------------------------------------------

def mac_vels_plain(g, dt, u, v, lux, lvx, luy, lvy, gpx, gpy, src):
    """(u_MAC, v_MAC), full padded frames."""
    return lm_interface.mac_vels(g, g.dx, g.dy, dt, u, v, lux, lvx, luy,
                                 lvy, gpx, gpy, src)


def rho_increment_plain(g, dt, rho, u_MAC, v_MAC, lrx, lry):
    """The (nx, ny) interior increment -dt div(rho_int U_MAC)."""
    rho_xint, rho_yint = lm_interface.rho_states(
        g, g.dx, g.dy, dt, rho, u_MAC, v_MAC, lrx, lry)
    rxi = ai(rho_xint, g)
    ryi = ai(rho_yint, g)
    um = ai(u_MAC, g)
    vm = ai(v_MAC, g)
    return -dt * ((rxi.ip(1) * um.ip(1) - rxi.v() * um.v()) / g.dx +
                  (ryi.jp(1) * vm.jp(1) - ryi.v() * vm.v()) / g.dy)


def advect_terms_plain(g, dt, u, v, lux, lvx, luy, lvy, gpx, gpy, src,
                       u_MAC, v_MAC):
    """The (nx, ny) interior advective terms (advect_x, advect_y)."""
    u_xint, v_xint, u_yint, v_yint = lm_interface.states(
        g, g.dx, g.dy, dt, u, v, lux, lvx, luy, lvy, gpx, gpy, src,
        u_MAC, v_MAC)
    um = ai(u_MAC, g)
    vm = ai(v_MAC, g)
    uxi = ai(u_xint, g)
    vxi = ai(v_xint, g)
    uyi = ai(u_yint, g)
    vyi = ai(v_yint, g)
    advect_x = (0.5 * (um.v() + um.ip(1)) * (uxi.ip(1) - uxi.v()) / g.dx +
                0.5 * (vm.v() + vm.jp(1)) * (uyi.jp(1) - uyi.v()) / g.dy)
    advect_y = (0.5 * (um.v() + um.ip(1)) * (vxi.ip(1) - vxi.v()) / g.dx +
                0.5 * (vm.v() + vm.jp(1)) * (vyi.jp(1) - vyi.v()) / g.dy)
    return advect_x, advect_y


# ---------------------------------------------------------------------------
# the entries
# ---------------------------------------------------------------------------

class LMInterface:
    """The three interface stages of lm_atm on one grid."""

    def __init__(self, g):
        if getattr(g, "coord_type", 0) != 0:
            raise NotImplementedError(
                "the lm_atm interface stages are Cartesian only, as in the "
                "JAX package (ROADMAP.md A.11)")
        if g.ng < 4:
            raise NotImplementedError(
                f"the lm_atm interface stages need ng >= 4, not {g.ng} "
                "(ROADMAP.md A.11)")
        self.g = g

    def _check(self, planes):
        g = self.g
        dev, dtype = planes[0].device, planes[0].dtype
        for a in planes:
            if not isinstance(a, torch.Tensor):
                raise TypeError("the lm_atm stages take torch.Tensors")
            if a.device != dev or a.dtype != dtype:
                raise ValueError("the lm_atm stages take planes of one "
                                 "device and dtype")
            if tuple(a.shape) != (g.qx, g.qy):
                raise ValueError(f"expected a ({g.qx}, {g.qy}) frame, got "
                                 f"{tuple(a.shape)}")
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"unsupported dtype {dtype}")
        return dev

    def _launch(self, name, dt, planes, outs):
        """Launch entry `name`'s kernel on the planes' device and current
        stream."""
        if self._check(planes).type != "cuda":
            raise ValueError("the lm_atm kernels take CUDA tensors")
        g = self.g
        planes = [a.contiguous() for a in planes]
        f = planes[0]
        covered(g.ng, f.dtype)
        tiles = plan(name, g.nx, g.ny, g.ng, f.dtype)
        t = "f32" if f.dtype == torch.float32 else "f64"
        fn = getattr(_load(), f"{name}_{t}")
        ptrs = (ctypes.c_void_p * len(planes))(*[a.data_ptr()
                                                 for a in planes])
        ints = (ctypes.c_int * 3)(g.nx, g.ny, g.ng)
        dbl = (ctypes.c_double * 3)(float(dt), g.dx, g.dy)
        with torch.cuda.device(f.device):
            stream = torch.cuda.current_stream(f.device).cuda_stream
            err = fn(ptrs, *[o.data_ptr() for o in outs], ints, dbl,
                     (ctypes.c_int * len(LmPlan.FIELDS))(*tiles.ints()),
                     stream)
        if err != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                               f"{err}")
        launches[name] += 1
        return outs

    def _interior(self, like, n):
        return [torch.empty((self.g.nx, self.g.ny), dtype=like.dtype,
                            device=like.device) for _ in range(n)]

    # -- mac_vels ---------------------------------------------------------
    def launch_mac(self, dt, *planes):
        u = planes[0]
        outs = [torch.empty_like(u, memory_format=torch.contiguous_format)
                for _ in range(2)]
        return tuple(self._launch("lm_mac", dt, planes, outs))

    def mac_vels(self, dt, u, v, lux, lvx, luy, lvy, gpx, gpy, src):
        """(u_MAC, v_MAC): the full padded frames."""
        planes = (u, v, lux, lvx, luy, lvy, gpx, gpy, src)
        if self._check(planes).type == "cpu":
            return mac_vels_plain(self.g, dt, *planes)
        return self.launch_mac(dt, *planes)

    # -- rho advection ----------------------------------------------------
    def launch_rho(self, dt, *planes):
        return self._launch("lm_rho", dt, planes,
                            self._interior(planes[0], 1))[0]

    def rho_increment(self, dt, rho, u_MAC, v_MAC, lrx, lry):
        """The (nx, ny) interior density increment."""
        planes = (rho, u_MAC, v_MAC, lrx, lry)
        if self._check(planes).type == "cpu":
            return rho_increment_plain(self.g, dt, *planes)
        return self.launch_rho(dt, *planes)

    # -- full states + advective terms ------------------------------------
    def launch_states(self, dt, *planes):
        return tuple(self._launch("lm_states", dt, planes,
                                  self._interior(planes[0], 2)))

    def advect_terms(self, dt, u, v, lux, lvx, luy, lvy, gpx, gpy, src,
                     u_MAC, v_MAC):
        """(advect_x, advect_y) on the (nx, ny) interior."""
        planes = (u, v, lux, lvx, luy, lvy, gpx, gpy, src, u_MAC, v_MAC)
        if self._check(planes).type == "cpu":
            return advect_terms_plain(self.g, dt, *planes)
        return self.launch_states(dt, *planes)


def work(entry, nx, ny, dtype, ng=4):
    """(bytes, operations) one call must move and do at least on an
    nx x ny grid: each input plane read once and each output written once,
    and the operations counted from lm_interface.cu (the first pass over
    the (lo-1, hi+2) window; lm_mac's faces over that window; rho's and
    the states' x and y faces of the interior cells, each once, and their
    differences over the interior)."""
    item = torch.empty((), dtype=dtype).element_size()
    frame = (nx + 2 * ng) * (ny + 2 * ng)
    w12, inner = (nx + 3) * (ny + 3), nx * ny
    faces = (nx + 1) * ny + nx * (ny + 1)
    if entry == "lm_mac":
        nbytes = (9 + 2) * frame
        ops = (FLOPS["hat"] + FLOPS["mac"]) * w12
    elif entry == "lm_rho":
        nbytes = 5 * frame + inner
        ops = (FLOPS["rho_hat"] * w12 + FLOPS["rho_face"] * faces +
               FLOPS["rho"] * inner)
    elif entry == "lm_states":
        nbytes = 11 * frame + 2 * inner
        ops = (FLOPS["hat"] * w12 + FLOPS["face"] * faces +
               FLOPS["states"] * inner)
    else:
        raise ValueError(f"unknown entry {entry}")
    return nbytes * item, ops
