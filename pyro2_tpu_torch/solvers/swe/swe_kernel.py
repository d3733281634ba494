"""The wrapper of the CUDA swe step kernel (pyro2_tpu_torch/csrc/swe_step.cu).

The kernel is the counterpart of the JAX package's fused Pallas step
(pyro2_tpu/solvers/swe/pallas_step.py::make_pallas_swe_step_padded).  It is
built with nvcc into a shared library under pyro2_tpu_torch/_build/ at
first use (pyro2_tpu_torch.util.cuda_build) and bound with ctypes.

`SWEStep(sim)(U, t, dt)` is the step the Simulation evolves with:

  * for a CUDA tensor it launches the kernel (or raises: there is no
    fallback), counting the launch in the module-level `launches`;
  * for a CPU tensor it runs the plain PyTorch step, `sim._make_step()`.

The kernel updates the interior and carries the input's ghost cells through
unchanged; `fill_BC_all` refills them before the next step.  Ghost fills and
the CFL timestep stay plain PyTorch, as they were plain JAX outside the
Pallas kernel.
"""

import ctypes

import torch

from pyro2_tpu_torch.solvers.swe.unsplit_fluxes import (SWE_ITEM,
                                                        check_flattening)
from pyro2_tpu_torch.util import cuda_build

__all__ = ["SWEStep", "build", "launches", "work", "flops_per_zone"]

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
        for name in ("swe_step_f32", "swe_step_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_double), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.swe_scratch_planes.argtypes = [ctypes.c_int]
        lib.swe_scratch_planes.restype = ctypes.c_int
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

    def launch(self, U, t, dt):
        """Launch the CUDA kernel on U's device and current stream."""
        global launches
        del t   # no time-dependent terms in swe
        self.check(U)
        if U.device.type != "cuda":
            raise ValueError("the CUDA swe kernel takes a CUDA tensor")
        doubles = list(self._doubles)
        doubles[2] = float(dt)

        lib = _load()
        nvar, qx, qy = self.shape
        out = torch.empty_like(U)
        scratch = torch.empty((lib.swe_scratch_planes(nvar), qx, qy),
                              dtype=U.dtype, device=U.device)
        fn = lib.swe_step_f32 if U.dtype == torch.float32 \
            else lib.swe_step_f64
        with torch.cuda.device(U.device):
            stream = torch.cuda.current_stream(U.device).cuda_stream
            err = fn(U.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                     (ctypes.c_int * len(self._ints))(*self._ints),
                     (ctypes.c_double * len(doubles))(*doubles), stream)
        if err != 0:
            raise RuntimeError(f"swe kernel launch failed: CUDA error {err}")
        launches += 1
        return out
