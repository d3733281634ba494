"""The wrapper of the CUDA CTU step kernel (pyro2_tpu_torch/csrc/ctu_step.cu).

The kernel is the counterpart of the JAX package's fused Pallas step
(pyro2_tpu/solvers/compressible/pallas_step.py::
make_pallas_ctu_step_padded_general), Cartesian and spherical geometry.
It is built with nvcc into a shared library under pyro2_tpu_torch/_build/
at first use (pyro2_tpu_torch.util.cuda_build) and bound with ctypes.  Its
batched entry, which the padded steps of padded_step.py launch, is bound
here too (`launch_batched`), with the stage prefixes of the periodic
padded step (`stages` 1..3: the pipeline cut short after the interface
states, the transverse corrections or the final Riemann pair).  A step is
one launch: each block computes one
output tile out of shared memory, and `plan` -- the tile, the halos each
stage reads and the block's shared-memory layout -- is worked out here and
handed to the kernel, so the CPU tests check it.

`CTUStep(sim)(U, t, dt)` is the step the Simulation evolves with:

  * for a CUDA tensor it launches the kernel (or raises: there is no
    fallback), counting the launch in the module-level `launches`; a
    float dt goes to the kernel by value (`ctu_step_*`), a 0-d tensor dt
    stays on the device, where the device-dt entry (`ctu_step_dev_*`)
    reads it, so the launch reads nothing from the host and can be
    captured into a CUDA graph (driver_loop.py);
  * for a CPU tensor it runs the plain PyTorch step, `sim._make_step()`,
    with either kind of dt.

The kernel updates the interior and carries the input's ghost cells through
unchanged; `fill_BC_all` refills them before the next step.  Ghost fills,
the external-source stack S and the CFL timestep stay plain PyTorch, as they
were plain JAX outside the Pallas kernel.  In spherical geometry the kernel
also reads the geometry buffer (`geometry`), built once per step object and
dtype on the device.  A problem source reaches the kernel as its energy
rate rho e_rate w(x, y): e_rate and the weight plane w of the problem
module's `source_weight` (simulation.energy_rate, made once on the
device); a problem source of another form raises on CUDA, naming ROADMAP.md
A.27.
"""

import ctypes
import functools

import numpy as np
import torch

from pyro2_tpu_torch.util import cuda_build

__all__ = ["CTUStep", "Plan", "build", "geometry", "launch_batched",
           "launches", "plan", "work", "FLOPS_PER_ZONE",
           "FLOPS_PER_ZONE_PREFIX", "FLOPS_PER_ZONE_PROBLEM",
           "FLOPS_PER_ZONE_SPHERICAL", "HALO", "TILE"]

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
# the same for the stage prefixes of the periodic padded step (stages 1..3):
# the traced states, then the first pair and the transverse corrections
# (5 operations a variable a state, two states a face, an x and a y face),
# then the final pair's two solves (riemann1's count) without the
# viscosity, each prefix ending in its sum of four states (3 adds a
# variable) or of two fluxes (1); stage 4 is the whole step
_TRACED = sum(FLOPS_PER_ZONE_BY_STAGE[k] for k in ("prim", "flatten",
                                                   "states"))
_PAIR = FLOPS_PER_ZONE_BY_STAGE["riemann1"]
_TRANSVERSE = 5 * 2 * 2 * 4
FLOPS_PER_ZONE_PREFIX = {1: _TRACED + 3 * 4,
                         2: _TRACED + _PAIR + _TRANSVERSE + 3 * 4,
                         3: _TRACED + 2 * _PAIR + _TRANSVERSE + 4,
                         4: FLOPS_PER_ZONE}
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
# a problem's energy source in the predictor-corrector: (rho e_rate) w and
# its sum into S_old's and S_new's energy rows
FLOPS_PER_ZONE_PROBLEM = 6

launches = 0   # kernel launches made through CTUStep (read by chip_smoke.py)

# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

# the output tile of a block, (rows along x, columns along y), by dtype:
# with its 1-cell halo, 32 x 16 traced cells, one for each of float32's 512
# threads a block, and 16 x 16 for float64's 256 (ctu_step.cu's Launch),
# whose block fits the shared memory for every configuration (nvar up to
# MAXVAR, spherical, sources)
TILE = {torch.float32: (30, 14), torch.float64: (14, 14)}
THREADS = {torch.float32: 512, torch.float64: 256}

# how far beyond the output tile each box of a block reaches (ctu_step.cu's
# phases): the traced cells (the states of the faces the tile's fluxes
# read, and the corners of the viscosity's vertex divergence), the 1-D
# flattening coefficients (a traced cell reads its neighbours') and the
# primitives (a coefficient and the 4th-order MC slope read 2 away)
HALO = {"traced": 1, "flatten": 2, "prim": 4}


class Plan:
    """One launch's tiling: the tile (tx rows, ty columns), the block's
    threads, the grid of tiles (blocks along y, along x, members) the
    launch takes, and the block's shared memory: `offsets` of each array
    in elements of the dtype (-1 when the configuration has none), `smem`
    in bytes.  `ints()` is the array the kernel takes."""

    ARRAYS = ("q", "xi", "st", "f1", "u", "dv", "s", "g", "p1", "p2")

    def __init__(self, nx, ny, nvar, dtype, *, spherical=False,
                 with_sources=False, flatten=True, n_members=1,
                 problem=False):
        self.nx, self.ny, self.nvar = nx, ny, nvar
        self.tx, self.ty = TILE[dtype]
        self.threads = THREADS[dtype]
        self.halo = dict(HALO)
        self.grid = (-(-ny // self.ty), -(-nx // self.tx), n_members)
        item = torch.empty((), dtype=dtype).element_size()
        traced = self.box("traced")
        sizes = {
            "q": nvar * self.box("prim"),
            "xi": 2 * self.box("flatten") if flatten else 0,
            "st": 4 * nvar * traced,       # each traced cell's four states
            "f1": 2 * nvar * traced,       # the first pair, x and y faces
            "u": nvar * traced,            # the floored state
            "dv": traced,                  # the vertex divergence
            # S's xmom, ymom and ener rows, and a problem's weight plane
            "s": (4 if problem else 3) * traced if with_sources else 0,
            "g": 4 * traced if spherical else 0,
            "p1": 2 * traced if spherical else 0,
            "p2": 2 * traced if spherical else 0,
        }
        self.sizes = sizes
        self.offsets, end = {}, 0
        for name in self.ARRAYS:
            self.offsets[name] = end if sizes[name] else -1
            end += sizes[name]
        self.smem = end * item

    def box(self, name):
        """Cells of a block's box: the tile and its halo."""
        h = self.halo[name]
        return (self.tx + 2 * h) * (self.ty + 2 * h)

    def ints(self):
        h = self.halo
        return [self.tx, self.ty, self.threads,
                h["prim"], h["flatten"], h["traced"],
                *(self.offsets[a] for a in self.ARRAYS), self.smem,
                *self.grid[:2]]


@functools.lru_cache(maxsize=64)
def plan(nx, ny, nvar, dtype, **kw):
    """The launch plan of one step (see Plan), made once for each set of
    arguments."""
    return Plan(nx, ny, nvar, dtype, **kw)


def covered(ivars, ng):
    """Raise NotImplementedError unless the fused kernel covers this frame:
    4..MAXVAR variables, the conserved ones first in the order density,
    energy, x-, y-momentum (the order the compressible solvers register
    them in), and ghosts as deep as the primitives' halo."""
    if not 4 <= ivars.nvar <= MAXVAR:
        raise NotImplementedError(
            f"the CTU kernel takes 4..{MAXVAR} variables, not {ivars.nvar}"
            " (ROADMAP.md A.21)")
    order = (ivars.idens, ivars.iener, ivars.ixmom, ivars.iymom)
    if order != (0, 1, 2, 3) or ng < HALO["prim"]:
        raise NotImplementedError(
            "the CTU kernel takes density, energy, x- and y-momentum at "
            f"0..3 and {HALO['prim']} or more ghost cells, not {order} and "
            f"{ng} (ROADMAP.md A.21)")


def _c_plan(p):
    ints = p.ints()
    return (ctypes.c_int * len(ints))(*ints)


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
            # U, S, G, W, out, ints, doubles, plan, stream
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ints, doubles, ints,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ("ctu_step_dev_f32", "ctu_step_dev_f64"):
            # U, S, G, W, out, ints, doubles, plan, dt, stream
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ints, doubles, ints,
                                                   ctypes.c_void_p,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ("ctu_step_batched_f32", "ctu_step_batched_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ints,
                                                   doubles, ints,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ("ctu_stage_batched_f32", "ctu_stage_batched_f64"):
            # U, out, n_members, ints, doubles, plan, stages, stream
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int, ints,
                                                   doubles, ints,
                                                   ctypes.c_int,
                                                   ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.ctu_plan_ints.restype = ctypes.c_int
        if lib.ctu_plan_ints() != len(Plan.ARRAYS) + 9:
            raise RuntimeError("ctu_step.cu takes another plan layout")
        _lib = lib
    return _lib


def work(nx, ny, nvar, dtype, with_sources=False, spherical=False,
         n_members=1, problem=False, stages=4):
    """(bytes, operations) one step of n_members states must move and do at
    least: each state read once and written once (plus the S stack when
    there are sources, a problem source's weight plane, and in spherical
    geometry the geometry buffer), and FLOPS_PER_ZONE (spherical:
    FLOPS_PER_ZONE_SPHERICAL; with a problem source FLOPS_PER_ZONE_PROBLEM
    more; a stage prefix FLOPS_PER_ZONE_PREFIX[stages]) per interior
    zone.  A prefix moves the whole step's bytes: it reads the state and
    writes a frame of its size."""
    item = torch.empty((), dtype=dtype).element_size()
    qx, qy = nx + 8, ny + 8
    values = (2 * nvar + (4 if with_sources else 0) +
              (1 if problem else 0)) * qx * qy
    flops = FLOPS_PER_ZONE_SPHERICAL if spherical else \
        FLOPS_PER_ZONE_PREFIX[stages]
    if problem:
        flops += FLOPS_PER_ZONE_PROBLEM
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
             myg.sin_yl, myg.sin_y, myg.sin_yb]
    host = np.concatenate([np.ascontiguousarray(a, dtype=np.float64).ravel()
                           for a in parts])
    return torch.as_tensor(host, dtype=dtype, device=device)


def launch_batched(P, ints, doubles, n_members, stages=4):
    """One launch of the batched entry on the n_members states of P (a
    contiguous CUDA tensor, members one after another, each an (nvar, qx,
    qy) stack): the CTU step without floor, sources, sponge and walls, or
    with stages 1..3 its prefix (ctu_stage_batched_*, four variables).
    Returns the new states; the caller counts the launch."""
    if P.device.type != "cuda":
        raise ValueError("the CUDA CTU kernel takes a CUDA tensor")
    lib = _load()
    tiles = plan(ints[1], ints[2], ints[0], P.dtype,
                 flatten=bool(ints[10]), n_members=n_members)
    out = torch.empty_like(P)
    sfx = "f32" if P.dtype == torch.float32 else "f64"
    args = (P.data_ptr(), out.data_ptr(), n_members,
            (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_double * len(doubles))(*doubles), _c_plan(tiles))
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream(P.device).cuda_stream
        if stages == 4:
            err = getattr(lib, f"ctu_step_batched_{sfx}")(*args, stream)
        else:
            err = getattr(lib, f"ctu_stage_batched_{sfx}")(*args, stages,
                                                           stream)
    if err != 0:
        raise RuntimeError(f"CTU kernel launch failed: CUDA error {err}")
    return out


class CTUStep:
    """step(U, t, dt) -> U_new for a live compressible Simulation."""

    def __init__(self, sim):
        rp = sim.rp
        myg = sim.cc_data.grid
        ivars = sim.ivars
        method = rp.get_param("compressible.riemann")
        if method not in RIEMANN:
            raise ValueError(f"unknown Riemann solver {method}")
        covered(ivars, myg.ng)

        self.sim = sim
        self.plain = sim._make_step()
        self.shape = (ivars.nvar, myg.qx, myg.qy)
        self.small_dens = rp.get_param("compressible.small_dens")
        self.spherical = getattr(myg, "coord_type", 0) == 1
        self.problem = sim.problem_source is not None
        # the geometric source terms act with grav = 0 too, and so does a
        # problem's source
        self.with_sources = (rp.get_param("compressible.grav") != 0.0 or
                             self.spherical or self.problem)
        solid = sim.solid
        self._ints = [ivars.nvar, myg.nx, myg.ny, myg.ng,
                      ivars.idens, ivars.ixmom, ivars.iymom, ivars.iener,
                      RIEMANN[method], rp.get_param("compressible.limiter"),
                      int(bool(rp.get_param("compressible.use_flattening"))),
                      int(self.with_sources),
                      int(bool(rp.get_param("sponge.do_sponge"))),
                      0,  # has_floor, set per dtype
                      solid.xl, solid.xr, solid.yl, solid.yr,
                      int(self.spherical), int(self.problem),
                      # the domain-edge flags of the artificial viscosity
                      # (0 on a sharded block's seams)
                      *(int(e) for e in sim.domain_edges.flags())]
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
                         rp.get_param("sponge.sponge_timescale"),
                         0.0]   # e_rate, set per call

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

    def kernel_args(self, U, t, dt, e_rate=0.0):
        """(int parameters, double parameters, S stack or None) of one
        kernel call on U.  S is the ghost-filled external-source stack of
        the floored state, the problem's source included, built in PyTorch
        on U's device; the doubles end with the problem source's e_rate
        (simulation.energy_rate).  A tensor dt is left on the device (the
        doubles' dt is then 0.0, which the device-dt entry does not
        read)."""
        sim = self.sim
        floor_min = torch.finfo(U.dtype).min
        ints = list(self._ints)
        doubles = list(self._doubles)
        ints[13] = int(self.small_dens > floor_min)
        if not isinstance(dt, torch.Tensor):
            doubles[2] = float(dt)
        doubles[8] = max(self.small_dens, floor_min)
        doubles[13] = e_rate

        S = None
        if self.with_sources:
            from pyro2_tpu_torch.solvers.compressible import simulation
            from pyro2_tpu_torch.solvers.compressible.unsplit_fluxes import \
                source_stack
            Uf = sim.clean_state(U) if ints[13] else U
            S = source_stack(simulation.get_external_sources(
                t, dt, Uf, sim.ivars, sim.rp, sim.cc_data.grid,
                problem_source=sim.problem_source), sim.ivars)
            S = sim.aux_data.fill_bc_stack(S, t=t)
        return ints, doubles, S

    def launch(self, U, t, dt):
        """Launch the CUDA kernel on U's device and current stream: the
        host-dt entry for a float dt, the device-dt entry for a 0-d tensor
        of U's dtype on its device."""
        from pyro2_tpu_torch.solvers.compressible.simulation import \
            energy_rate

        global launches
        self.check(U)
        e_rate, W = energy_rate(self.sim, U)
        if U.device.type != "cuda":
            raise ValueError("the CUDA CTU kernel takes a CUDA tensor")
        on_device = isinstance(dt, torch.Tensor)
        if on_device and (dt.shape != () or dt.dtype != U.dtype or
                          dt.device != U.device):
            raise ValueError("a device dt is a 0-d tensor of the state's "
                             "dtype on its device")
        if on_device and U.shape[0] != 4:
            raise NotImplementedError(
                "the device-dt CTU entry takes the compressible solver's 4 "
                "variables; passive scalars wait for a later slice of the "
                "port (ROADMAP.md A.28)")
        ints, doubles, S = self.kernel_args(U, t, dt, e_rate)

        lib = _load()
        nvar, nx, ny = ints[0], ints[1], ints[2]
        tiles = plan(nx, ny, nvar, U.dtype, spherical=self.spherical,
                     with_sources=self.with_sources, flatten=bool(ints[10]),
                     problem=self.problem)
        G = None
        if self.spherical:
            key = (U.dtype, U.device)
            if key not in self._geometry:
                self._geometry[key] = geometry(self.sim.cc_data.grid,
                                               U.dtype, U.device)
            G = self._geometry[key]
        out = torch.empty_like(U)
        sfx = "f32" if U.dtype == torch.float32 else "f64"
        args = (U.data_ptr(), None if S is None else S.data_ptr(),
                None if G is None else G.data_ptr(),
                None if W is None else W.data_ptr(), out.data_ptr(),
                (ctypes.c_int * len(ints))(*ints),
                (ctypes.c_double * len(doubles))(*doubles), _c_plan(tiles))
        with torch.cuda.device(U.device):
            stream = torch.cuda.current_stream(U.device).cuda_stream
            if on_device:
                err = getattr(lib, f"ctu_step_dev_{sfx}")(
                    *args, dt.data_ptr(), stream)
            else:
                err = getattr(lib, f"ctu_step_{sfx}")(*args, stream)
        if err != 0:
            raise RuntimeError(f"CTU kernel launch failed: CUDA error {err}")
        launches += 1
        return out
