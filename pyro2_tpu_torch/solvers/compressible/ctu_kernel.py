"""The wrapper of the CUDA CTU step kernel (pyro2_tpu_torch/csrc/ctu_step.cu).

The kernel is the counterpart of the JAX package's fused Pallas step
(pyro2_tpu/solvers/compressible/pallas_step.py::
make_pallas_ctu_step_padded_general), Cartesian and spherical geometry.
It is built with nvcc into a shared library under pyro2_tpu_torch/_build/
at first use (pyro2_tpu_torch.util.cuda_build) and bound with ctypes.  Its
batched entry, which the padded steps of padded_step.py launch, is bound
here too (`launch_batched`).

`CTUStep(sim)(U, t, dt)` is the step the Simulation evolves with:

  * for a CUDA tensor it launches the kernel (or raises: there is no
    fallback), counting the launch in the module-level `launches`;
  * for a CPU tensor it runs the plain PyTorch step, `sim._make_step()`.

The kernel updates the interior and carries the input's ghost cells through
unchanged; `fill_BC_all` refills them before the next step.  Ghost fills,
the external-source stack S and the CFL timestep stay plain PyTorch, as they
were plain JAX outside the Pallas kernel.  In spherical geometry the kernel
also reads the geometry buffer (`geometry`), built once per step object and
dtype on the device.
"""

import ctypes

import numpy as np
import torch

from pyro2_tpu_torch.util import cuda_build

__all__ = ["CTUStep", "build", "geometry", "launch_batched", "launches",
           "work", "FLOPS_PER_ZONE", "FLOPS_PER_ZONE_SPHERICAL"]

SOURCE = cuda_build.CSRC / "ctu_step.cu"

MAXVAR = cuda_build.MAXVAR
RIEMANN = {"HLLC": 0, "HLLC_lm": 1, "CGF": 2}

# floating-point operations per zone of one step, counted from ctu_step.cu
# for the main path's configuration (HLLC, limiter 2, flattening on, nvar 4,
# no sources, no sponge; +, -, *, /, sqrt, pow each one operation):
FLOPS_PER_ZONE_BY_STAGE = {
    "prim": 11,        # cons -> prim with the rho == 0 guard
    "flatten": 22,     # two 1-D flattening coefficients
    "states": 420,     # 4th-order MC slopes, tracing, prim -> cons, x and y
    "riemann1": 232,   # two HLLC solves (one x, one y interface)
    "riemann2": 400,   # transverse corrections, two HLLC solves, avisc
    "update": 36,      # conservative update
}
FLOPS_PER_ZONE = sum(FLOPS_PER_ZONE_BY_STAGE.values())
# the same for the spherical configuration (CGF, limiter 2, flattening on,
# nvar 4, the half-dt and predictor-corrector sources, which spherical
# geometry always has): CGF ~142 per face plus ~11 for its interface
# pressure, the d(log A) sources, the area and volume weights, the
# pressure gradients and the spherical vertex divergence
FLOPS_PER_ZONE_SPHERICAL_BY_STAGE = {
    "prim": 11,
    "flatten": 22,
    "states": 466,     # + per-cell dt/L, d(log A) sources, half-dt sources
    "riemann1": 306,   # two CGF solves and their interface pressures
    "riemann2": 534,   # area-weighted transverse corrections and pressure
                       # gradients, two CGF solves, spherical avisc
    "update": 83,      # area/volume update, pressure gradients, sources
}
FLOPS_PER_ZONE_SPHERICAL = sum(FLOPS_PER_ZONE_SPHERICAL_BY_STAGE.values())

launches = 0   # kernel launches made through CTUStep (read by chip_smoke.py)

_lib = None


def build(verbose=False):
    """Compile ctu_step.cu (if its library is not built yet).

    Returns (library path, seconds spent in nvcc, nvcc's stderr).  With
    verbose=True ptxas reports registers, shared memory and spills."""
    return cuda_build.build(SOURCE, verbose)


def _load():
    global _lib
    if _lib is None:
        so, _, _ = build()
        lib = ctypes.CDLL(str(so))
        ints = ctypes.POINTER(ctypes.c_int)
        doubles = ctypes.POINTER(ctypes.c_double)
        for name in ("ctu_step_f32", "ctu_step_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ints, doubles,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ("ctu_step_batched_f32", "ctu_step_batched_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ints,
                                                   doubles, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.ctu_scratch_planes.argtypes = [ctypes.c_int]
        lib.ctu_scratch_planes.restype = ctypes.c_int
        _lib = lib
    return _lib


def work(nx, ny, nvar, dtype, with_sources=False, spherical=False,
         n_members=1):
    """(bytes, operations) one step of n_members states must move and do at
    least: each state read once and written once (plus the S stack when
    there are sources, and in spherical geometry the geometry buffer), and
    FLOPS_PER_ZONE (spherical: FLOPS_PER_ZONE_SPHERICAL) per interior
    zone."""
    item = torch.empty((), dtype=dtype).element_size()
    qx, qy = nx + 8, ny + 8
    values = (2 * nvar + (4 if with_sources else 0)) * qx * qy
    flops = FLOPS_PER_ZONE_SPHERICAL if spherical else FLOPS_PER_ZONE
    if spherical:
        values += GEOMETRY_PLANES * qx * qy + GEOMETRY_ROWS * qx + \
            GEOMETRY_LANES * qy
    return n_members * values * item, n_members * flops * nx * ny


# the geometry buffer of a SphericalPolar grid (ctu_step.cu's Geom): the
# planes Ax, Ay, V, dlogAy; the lines over i Ly, dlogAx, r, r at the node
# and r - dr; the lines over j sin(theta) at the node, the centre and the
# centre below
GEOMETRY_PLANES, GEOMETRY_ROWS, GEOMETRY_LANES = 4, 5, 3


def geometry(myg, dtype, device):
    """The spherical geometry buffer of grid myg: the grid's float64 host
    arrays, laid out as ctu_step.cu reads them and rounded once to dtype.
    Lx is dr everywhere, which the kernel takes as the scalar dx."""
    if not np.array_equal(myg.Lx, np.full_like(myg.Lx, myg.dx)):
        raise ValueError("the CTU kernel takes Lx = dx everywhere")
    parts = [myg.Ax, myg.Ay, myg.V, myg.dlogAy,
             myg.Ly[:, 0], myg.dlogAx[:, 0], myg.x, myg.xl, myg.x - myg.dx,
             np.sin(myg.yl), np.sin(myg.y), np.sin(myg.y - myg.dy)]
    host = np.concatenate([np.ascontiguousarray(a, dtype=np.float64).ravel()
                           for a in parts])
    return torch.as_tensor(host, dtype=dtype, device=device)


def launch_batched(P, ints, doubles, n_members):
    """One launch of the batched entry on the n_members states of P (a
    contiguous CUDA tensor, members one after another, each an (nvar, qx,
    qy) stack): the CTU step without floor, sources, sponge and walls.
    Returns the new states; the caller counts the launch."""
    if P.device.type != "cuda":
        raise ValueError("the CUDA CTU kernel takes a CUDA tensor")
    lib = _load()
    nvar, qx, qy = ints[0], ints[1] + 2 * ints[3], ints[2] + 2 * ints[3]
    out = torch.empty_like(P)
    scratch = torch.empty(
        (n_members * lib.ctu_scratch_planes(nvar), qx, qy), dtype=P.dtype,
        device=P.device)
    fn = lib.ctu_step_batched_f32 if P.dtype == torch.float32 \
        else lib.ctu_step_batched_f64
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        err = fn(P.data_ptr(), out.data_ptr(), scratch.data_ptr(), n_members,
                 (ctypes.c_int * len(ints))(*ints),
                 (ctypes.c_double * len(doubles))(*doubles), stream)
    if err != 0:
        raise RuntimeError(f"CTU kernel launch failed: CUDA error {err}")
    return out


class CTUStep:
    """step(U, t, dt) -> U_new for a live compressible Simulation."""

    def __init__(self, sim):
        rp = sim.rp
        myg = sim.cc_data.grid
        ivars = sim.ivars
        if sim.problem_source is not None:
            raise NotImplementedError(
                "problem source terms wait for a later slice of the port "
                "(ROADMAP.md, queue B item 1)")
        if not 4 <= ivars.nvar <= MAXVAR:
            raise NotImplementedError(
                f"the CTU kernel takes 4..{MAXVAR} variables, not "
                f"{ivars.nvar}")
        method = rp.get_param("compressible.riemann")
        if method not in RIEMANN:
            raise ValueError(f"unknown Riemann solver {method}")

        self.sim = sim
        self.plain = sim._make_step()
        self.shape = (ivars.nvar, myg.qx, myg.qy)
        self.small_dens = rp.get_param("compressible.small_dens")
        self.spherical = getattr(myg, "coord_type", 0) == 1
        # the geometric source terms act with grav = 0 too
        self.with_sources = (rp.get_param("compressible.grav") != 0.0 or
                             self.spherical)
        solid = sim.solid
        self._ints = [ivars.nvar, myg.nx, myg.ny, myg.ng,
                      ivars.idens, ivars.ixmom, ivars.iymom, ivars.iener,
                      RIEMANN[method], rp.get_param("compressible.limiter"),
                      int(bool(rp.get_param("compressible.use_flattening"))),
                      int(self.with_sources),
                      int(bool(rp.get_param("sponge.do_sponge"))),
                      0,  # has_floor, set per dtype
                      solid.xl, solid.xr, solid.yl, solid.yr,
                      int(self.spherical)]
        self._geometry = {}     # the spherical geometry buffer by dtype
        self._doubles = [myg.dx, myg.dy, 0.0,  # dt, set per call
                         rp.get_param("eos.gamma"),
                         rp.get_param("compressible.z0"),
                         rp.get_param("compressible.z1"),
                         rp.get_param("compressible.delta"),
                         rp.get_param("compressible.cvisc"),
                         0.0,  # floor, set per dtype
                         rp.get_param("compressible.grav"),
                         rp.get_param("sponge.sponge_rho_begin"),
                         rp.get_param("sponge.sponge_rho_full"),
                         rp.get_param("sponge.sponge_timescale")]

    def check(self, U):
        """Raise on anything the kernel and its plain version do not take."""
        if not isinstance(U, torch.Tensor):
            raise TypeError("the CTU step takes a torch.Tensor")
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

    def kernel_args(self, U, t, dt):
        """(int parameters, double parameters, S stack or None) of one
        kernel call on U.  S is the ghost-filled external-source stack of
        the floored state, built in PyTorch on U's device."""
        sim = self.sim
        floor_min = torch.finfo(U.dtype).min
        ints = list(self._ints)
        doubles = list(self._doubles)
        ints[13] = int(self.small_dens > floor_min)
        doubles[2] = float(dt)
        doubles[8] = max(self.small_dens, floor_min)

        S = None
        if self.with_sources:
            from pyro2_tpu_torch.solvers.compressible import simulation
            from pyro2_tpu_torch.solvers.compressible.unsplit_fluxes import \
                source_stack
            Uf = sim.clean_state(U) if ints[13] else U
            S = source_stack(simulation.get_external_sources(
                t, dt, Uf, sim.ivars, sim.rp, sim.cc_data.grid), sim.ivars)
            S = sim.aux_data.fill_bc_stack(S, t=t)
        return ints, doubles, S

    def launch(self, U, t, dt):
        """Launch the CUDA kernel on U's device and current stream."""
        global launches
        self.check(U)
        if U.device.type != "cuda":
            raise ValueError("the CUDA CTU kernel takes a CUDA tensor")
        ints, doubles, S = self.kernel_args(U, t, dt)

        lib = _load()
        nvar, qx, qy = self.shape
        G = None
        if self.spherical:
            key = (U.dtype, U.device)
            if key not in self._geometry:
                self._geometry[key] = geometry(self.sim.cc_data.grid,
                                               U.dtype, U.device)
            G = self._geometry[key]
        out = torch.empty_like(U)
        scratch = torch.empty((lib.ctu_scratch_planes(nvar), qx, qy),
                              dtype=U.dtype, device=U.device)
        fn = lib.ctu_step_f32 if U.dtype == torch.float32 \
            else lib.ctu_step_f64
        with torch.cuda.device(U.device):
            stream = torch.cuda.current_stream(U.device).cuda_stream
            err = fn(U.data_ptr(), None if S is None else S.data_ptr(),
                     None if G is None else G.data_ptr(),
                     out.data_ptr(), scratch.data_ptr(),
                     (ctypes.c_int * len(ints))(*ints),
                     (ctypes.c_double * len(doubles))(*doubles), stream)
        if err != 0:
            raise RuntimeError(f"CTU kernel launch failed: CUDA error {err}")
        launches += 1
        return out
