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

For a CUDA tensor each entry launches its kernel chain, counting the call
once in `launches` (lm_mac, lm_rho, lm_states), or raises; for a CPU tensor
it runs its plain version (`mac_vels_plain`, ...), the expressions of the
JAX package's jnp path (lm_atm/simulation.py) over LM_atm_interface.  There
is no fallback from one to the other.  The kernels take Cartesian grids
with ng >= 4 (lm_atm's is 4) of any nx, ny.  The MC slopes come in as
planes, computed globally by mesh/reconstruction.limit.
"""

import ctypes

import torch

from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.solvers.lm_atm import LM_atm_interface as lm_interface
from pyro2_tpu_torch.util import cuda_build

__all__ = ["LMInterface", "advect_terms_plain", "build", "launches",
           "mac_vels_plain", "rho_increment_plain", "work"]

SOURCE = cuda_build.CSRC / "lm_interface.cu"

launches = {"lm_mac": 0, "lm_rho": 0, "lm_states": 0}

# floating-point operations, counted from lm_interface.cu (+, -, *, / each
# one): per cell of the (lo-1, hi+2) window for the first stage of each
# chain, per cell of that window (mac) or of the interior (rho, states)
# for the second
FLOPS = {"hat": 42, "mac": 58, "rho_hat": 20, "rho": 130, "states": 242}

# scratch planes of each chain (the first-pass interface values)
SCRATCH = {"lm_mac": 6, "lm_rho": 2, "lm_states": 6}

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
        tail = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_double),
                ptr]
        for t in ("f32", "f64"):
            getattr(lib, f"lm_mac_{t}").argtypes = [ptr] * 4 + tail
            getattr(lib, f"lm_states_{t}").argtypes = [ptr] * 4 + tail
            getattr(lib, f"lm_rho_{t}").argtypes = [ptr] * 3 + tail
            for name in ("mac", "states", "rho"):
                getattr(lib, f"lm_{name}_{t}").restype = ctypes.c_int
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
        """Launch one chain on the planes' device and current stream."""
        if self._check(planes).type != "cuda":
            raise ValueError("the lm_atm kernels take CUDA tensors")
        g = self.g
        planes = [a.contiguous() for a in planes]
        f = planes[0]
        scratch = torch.empty((SCRATCH[name], g.qx, g.qy), dtype=f.dtype,
                              device=f.device)
        t = "f32" if f.dtype == torch.float32 else "f64"
        fn = getattr(_load(), f"{name}_{t}")
        ptrs = (ctypes.c_void_p * len(planes))(*[a.data_ptr()
                                                 for a in planes])
        ints = (ctypes.c_int * 3)(g.nx, g.ny, g.ng)
        dbl = (ctypes.c_double * 3)(float(dt), g.dx, g.dy)
        with torch.cuda.device(f.device):
            stream = torch.cuda.current_stream(f.device).cuda_stream
            err = fn(ptrs, *[o.data_ptr() for o in outs],
                     scratch.data_ptr(), ints, dbl, stream)
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
    and the operations counted from lm_interface.cu (first stage over the
    (lo-1, hi+2) window, second over that window for lm_mac and over the
    interior otherwise)."""
    item = torch.empty((), dtype=dtype).element_size()
    frame = (nx + 2 * ng) * (ny + 2 * ng)
    w12, inner = (nx + 3) * (ny + 3), nx * ny
    if entry == "lm_mac":
        nbytes = (9 + 2) * frame
        ops = (FLOPS["hat"] + FLOPS["mac"]) * w12
    elif entry == "lm_rho":
        nbytes = 5 * frame + inner
        ops = FLOPS["rho_hat"] * w12 + FLOPS["rho"] * inner
    elif entry == "lm_states":
        nbytes = 11 * frame + 2 * inner
        ops = FLOPS["hat"] * w12 + FLOPS["states"] * inner
    else:
        raise ValueError(f"unknown entry {entry}")
    return nbytes * item, ops
