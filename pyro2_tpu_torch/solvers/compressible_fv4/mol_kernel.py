"""The wrapper of the CUDA MOL stage-increment kernels
(pyro2_tpu_torch/csrc/mol_substep.cu).

The kernels are the counterpart of the JAX package's fused Pallas band
kernel (pyro2_tpu/solvers/compressible_fv4/pallas_step.py::
make_pallas_mol_substep) through both of its builders: kind "rk" is the
2nd-order pipeline of compressible_rk (PLM, one Riemann pass, artificial
viscosity), kind "fv4" the McCorquodale-Colella pipeline of
compressible_fv4, which compressible_sdc inherits.  They are built with
nvcc into a shared library under pyro2_tpu_torch/_build/ at first use
(pyro2_tpu_torch.util.cuda_build) and bound with ctypes.

Each kind is one launch a stage, each block computing one output tile out
of shared memory; `rk_plan` and `plan` -- the tile, the halos each stage
reads and the block's shared-memory layout -- are worked out here and
handed to the kernel, so the CPU tests check them.

`MOLSubstep(sim, kind)(U, t, dt)` is the stage increment k the Simulation
evolves with.  U is the ghost-filled (nvar, qx, qy) stack; k has its shape
and is exactly zero on every ghost cell.

  * for a CUDA tensor it launches the kernel (or raises: there is no
    fallback), counting the launch in the module-level `launches`;
  * for a CPU tensor it runs the plain PyTorch version,
    `sim._make_substep()` (compressible_rk.build_substep or
    compressible_fv4.build_substep).

Unlike the TPU kernel, the CUDA entries cover solid walls and a positive
density floor, gated on the global interior, and, in the kernels' extended
instantiation, SphericalPolar grids (their lines, `lines`, made once on the
device), a problem's energy source rho e_rate w(x, y) (the problem module's
`source_weight`; a problem source of another form raises
NotImplementedError naming ROADMAP.md A.27) and rk's well-balanced
reconstruction.  A frame whose conserved variables are not in the solvers'
order raises NotImplementedError (`covered`).
"""

import ctypes
import functools

import numpy as np
import torch

from pyro2_tpu_torch.solvers.compressible.ctu_kernel import MAXVAR, RIEMANN
from pyro2_tpu_torch.solvers.compressible.simulation import energy_rate
from pyro2_tpu_torch.solvers.compressible_fv4.fluxes import ALPHA, BETA
from pyro2_tpu_torch.util import cuda_build

__all__ = ["MOLSubstep", "Plan", "RkPlan", "build", "covered", "launches",
           "lines", "plan", "rk_plan", "work", "increment_scale", "KINDS",
           "FLOPS_PER_ZONE_BY_STAGE", "FLOPS_PER_ZONE_EXTENDED", "HALO",
           "RK_HALO", "RK_TILE", "TILE"]

SOURCE = cuda_build.CSRC / "mol_substep.cu"

KINDS = ("rk", "fv4")

# floating-point operations per interior zone of one stage increment,
# counted from mol_substep.cu and euler_common.cuh for the main paths'
# configurations (nvar 4, flattening on, no sponge; rk with HLLC and
# limiter 2, fv4 with its CGF solver; +, -, *, /, sqrt, pow and cos each
# one operation, compares, selects, min and max none; a branch counted by
# its longer arm).  Stages that run on a wider window than the interior
# are counted per interior zone all the same.
FLOPS_PER_ZONE_BY_STAGE = {
    "rk": {
        "prim": 11,        # cons -> prim with the rho == 0 guard
        "flatten": 22,     # two 1-D flattening coefficients
        "states": 246,     # 8 x (4th-order MC slope 21, xi dq, q -+ dq/2),
                           # 4 prim -> cons of 9
        "flux": 318,       # two HLLC solves (116 each), two avisc (43)
        "update": 24,      # flux divergence and the gravity source
    },
    "fv4": {
        "prim": 78,        # to centres (12 / var), the fallback test, two
                           # cons -> prim, the centred sources
        "flatten": 22,
        "qavg": 44,        # q_avg = q_cc + dx^2/24 lap(q_bar), 11 / var
        "faces": 760,      # per cell, direction and var one evaluation
                           # of the 4th-order limiter giving both its
                           # states (63) and their blends (8); one CGF
                           # solve on primitives (96) per face
        "flux": 256,       # per face: face centres (20), four flux_cons
                           # (15 each), the transverse Laplacian (20),
                           # the avisc (28)
        "update": 46,      # divergence (20) and the averaged sources (26)
    },
}

# the operations the extended instantiation adds per interior zone, by what
# it covers: the spherical sources (rk: and the spherical vertex
# divergence of two faces' viscosity, 2 x 2 x 16 more than the Cartesian
# one), a problem's energy source and (rk) the well-balanced pressure
# states; fv4 takes the Laplacian and average of one more source plane
FLOPS_PER_ZONE_EXTENDED = {
    "rk": {"spherical": 9 + 64, "problem": 3, "well_balanced": 20},
    "fv4": {"spherical": 9 + 11, "problem": 3, "well_balanced": 0},
}

launches = {"mol_rk": 0, "mol_fv4": 0}   # read by chip_smoke.py

# ---------------------------------------------------------------------------
# the fv4 kernel's launch plan
# ---------------------------------------------------------------------------

# the output tile of a block, (rows along x, columns along y), and its
# threads, by dtype: a float32 block of 512 threads whose 4-variable boxes
# (114,080 B) let two blocks share an SM, 32 warps at the kernel's 64
# registers (the fastest of the tiles and blocks timed on the H100,
# PERF.md), and a float64 block of 256 whose 8-variable boxes fit one
# block's shared memory
TILE = {torch.float32: (24, 32), torch.float64: (16, 16)}
THREADS = {torch.float32: 512, torch.float64: 256}

# how far beyond the output tile each box of a block reaches (mol_substep.cu
# k_fv4's stages): the cells whose limited face states stage 4 computes and
# the centred sources the averaged sources read ("states"); the flattening
# coefficients a cell's blend reads ("flatten"); the 4th-order averages,
# which the limiter reads 3 cells along its direction ("avg"); and the
# averages' primitives, which the Laplacian of q_avg reads ("prim").  Near
# the frame's edges the boxes reach past it, where the windows make every
# value the kernel reads come from inside it.
HALO = {"states": 1, "flatten": 2, "avg": 4, "prim": 5}


def _lay_out(plan, sizes, item):
    """Set a plan's `sizes`, `offsets` (each array after the one before it,
    in the order of plan.ARRAYS; -1 for an array the configuration does
    not have) and `smem` (bytes)."""
    plan.sizes = sizes
    plan.offsets, end = {}, 0
    for name in plan.ARRAYS:
        plan.offsets[name] = end if sizes[name] else -1
        end += sizes[name]
    plan.smem = end * item


class Plan:
    """One fv4 launch's tiling: the tile (tx rows, ty columns), the block's
    threads, the grid of tiles (blocks along y, along x), and the block's
    shared memory: `offsets` of each array in elements of the dtype (-1
    when the configuration has none), `smem` in bytes.  Array r holds the
    centres and the 4th-order averages, beside them the floored state and
    then the limited states, and after stage 4 the fluxes.  `ints()` is the array the kernel takes."""

    ARRAYS = ("q", "xi", "sc", "qix", "qiy", "r")

    def __init__(self, nx, ny, nvar, dtype, *, flatten=True,
                 extended=False):
        self.nx, self.ny, self.nvar = nx, ny, nvar
        self.tx, self.ty = TILE[dtype]
        self.threads = THREADS[dtype]
        self.halo = dict(HALO)
        self.grid = (-(-ny // self.ty), -(-nx // self.tx))
        item = torch.empty((), dtype=dtype).element_size()
        tx, ty = self.tx, self.ty
        # the centres / averages, then the limited states or, before them,
        # the floored state
        states = nvar * self.box("avg") + max(2 * nvar * self.box("states"),
                                              nvar * self.box("prim"))
        fluxes = nvar * ((tx + 1) * ty + tx * (ty + 1))
        _lay_out(self, {
            "q": nvar * self.box("prim"),
            "xi": 2 * self.box("flatten") if flatten else 0,
            # the centred sources of ymom and ener; in the extended
            # instantiation of xmom, ymom and ener
            "sc": (3 if extended else 2) * self.box("states"),
            "qix": nvar * (tx + 1) * (ty + 2),
            "qiy": nvar * (tx + 2) * (ty + 1),
            "r": max(states, fluxes),
        }, item)

    def box(self, name):
        """Cells of a block's box: the tile and its halo."""
        h = self.halo[name]
        return (self.tx + 2 * h) * (self.ty + 2 * h)

    def ints(self):
        h = self.halo
        return [self.tx, self.ty, self.threads,
                h["prim"], h["avg"], h["flatten"], h["states"],
                *(self.offsets[a] for a in self.ARRAYS), self.smem,
                *self.grid]


@functools.lru_cache(maxsize=64)
def plan(nx, ny, nvar, dtype, **kw):
    """The launch plan of one fv4 stage (see Plan), made once for each set
    of arguments."""
    return Plan(nx, ny, nvar, dtype, **kw)


# ---------------------------------------------------------------------------
# the rk kernel's launch plan
# ---------------------------------------------------------------------------

# the output tile of a block, (rows along x, columns along y), and its
# threads, by dtype: a float32 block of 512 threads whose 4-variable boxes
# (104,576 B) let two blocks share an SM, at the kernel's 64 registers,
# and a float64 block of 256 whose 8-variable boxes fit one block's shared
# memory
RK_TILE = {torch.float32: (32, 32), torch.float64: (16, 16)}
RK_THREADS = {torch.float32: 512, torch.float64: 256}

# how far beyond the output tile each box of a block reaches (mol_substep.cu
# k_rk's stages): the 1-D flattening coefficients, which the
# multidimensional coefficient of a state cell 1 cell beyond the tile reads
# 1 cell out ("flatten"); and the primitives, which the flattening
# coefficients read 2 cells out (and the states' slopes 2) ("prim").  The
# interface states cover the cells on either side of the tile's faces.
# Near the frame's edges the boxes reach past it, where the windows make
# every value the kernel reads come from inside it.
RK_HALO = {"flatten": 2, "prim": 4}


class RkPlan:
    """One rk launch's tiling: the tile (tx rows, ty columns), the block's
    threads, the grid of tiles (blocks along y, along x), and the block's
    shared memory: `offsets` of each array in elements of the dtype (-1
    when the configuration has none), `smem` in bytes.  Array s holds the
    x faces' interface states, then the y faces'.  `ints()` is the array
    the kernel takes."""

    ARRAYS = ("q", "xi", "s", "fx", "fy")

    def __init__(self, nx, ny, nvar, dtype, *, flatten=True):
        self.nx, self.ny, self.nvar = nx, ny, nvar
        self.tx, self.ty = RK_TILE[dtype]
        self.threads = RK_THREADS[dtype]
        self.halo = dict(RK_HALO)
        self.grid = (-(-ny // self.ty), -(-nx // self.tx))
        item = torch.empty((), dtype=dtype).element_size()
        tx, ty = self.tx, self.ty
        _lay_out(self, {
            "q": nvar * self.box("prim"),
            "xi": 2 * self.box("flatten") if flatten else 0,
            "s": 2 * nvar * max((tx + 2) * ty, tx * (ty + 2)),
            "fx": nvar * (tx + 1) * ty,
            "fy": nvar * tx * (ty + 1),
        }, item)

    def box(self, name):
        """Cells of a block's box: the tile and its halo."""
        h = self.halo[name]
        return (self.tx + 2 * h) * (self.ty + 2 * h)

    def ints(self):
        return [self.tx, self.ty, self.threads, self.halo["prim"],
                self.halo["flatten"],
                *(self.offsets[a] for a in self.ARRAYS), self.smem,
                *self.grid]


@functools.lru_cache(maxsize=64)
def rk_plan(nx, ny, nvar, dtype, **kw):
    """The launch plan of one rk stage (see RkPlan), made once for each set
    of arguments."""
    return RkPlan(nx, ny, nvar, dtype, **kw)


def covered(ivars):
    """Raise NotImplementedError unless the fused kernels take this frame's
    variables: density, energy, x- and y-momentum at 0..3 (the order the
    compressible solvers register them in)."""
    order = (ivars.idens, ivars.iener, ivars.ixmom, ivars.iymom)
    if order != (0, 1, 2, 3):
        raise NotImplementedError(
            "the MOL kernels take density, energy, x- and y-momentum at "
            f"0..3, not {order} (ROADMAP.md A.22)")

_lib = None


def build(verbose=False):
    """Compile mol_substep.cu (if its library is not built yet).

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
        for kind in KINDS:
            for dt in ("f32", "f64"):
                # U, lines, weight, k, ints, doubles, plan, stream
                fn = getattr(lib, f"mol_{kind}_substep_{dt}")
                fn.argtypes = [ctypes.c_void_p] * 4 + [ints, doubles, ints,
                                                       ctypes.c_void_p]
                fn.restype = ctypes.c_int
        lib.mol_rk_plan_ints.restype = ctypes.c_int
        lib.mol_fv4_plan_ints.restype = ctypes.c_int
        if (lib.mol_rk_plan_ints() != len(RkPlan.ARRAYS) + 8 or
                lib.mol_fv4_plan_ints() != len(Plan.ARRAYS) + 10):
            raise RuntimeError("mol_substep.cu takes another plan layout")
        _lib = lib
    return _lib


def work(kind, nx, ny, nvar, dtype, *, spherical=False, problem=False,
         well_balanced=False):
    """(bytes, operations) one stage increment must move and do at least:
    the state read once and k written once (and a problem source's weight
    plane, and on a SphericalPolar grid its lines), and the operations
    counted from the source per interior zone (FLOPS_PER_ZONE_BY_STAGE,
    plus FLOPS_PER_ZONE_EXTENDED for what the configuration covers)."""
    item = torch.empty((), dtype=dtype).element_size()
    qx, qy = nx + 8, ny + 8
    flops = sum(FLOPS_PER_ZONE_BY_STAGE[kind].values())
    values = 2 * nvar * qx * qy
    extra = FLOPS_PER_ZONE_EXTENDED[kind]
    if spherical:
        flops += extra["spherical"]
        values += LINES_ROWS * qx + LINES_LANES * qy
    if problem:
        flops += extra["problem"]
        values += qx * qy
    if well_balanced:
        flops += extra["well_balanced"]
    return values * item, flops * nx * ny


# the lines of a SphericalPolar grid (mol_substep.cu's Lines): over i the
# cell width Ly = r dtheta, the centre radius r, the node radius and r - dr;
# over j sin(theta) at the node, the centre and the centre below
LINES_ROWS, LINES_LANES = 4, 3


def lines(myg, dtype, device):
    """The lines buffer of SphericalPolar grid myg: the grid's float64 host
    arrays, laid out as mol_substep.cu reads them and rounded once to
    dtype."""
    parts = [myg.Ly[:, 0], myg.x, myg.xl, myg.x - myg.dx,
             np.sin(myg.yl), np.sin(myg.y), np.sin(myg.y - myg.dy)]
    host = np.concatenate([np.ascontiguousarray(a, dtype=np.float64).ravel()
                           for a in parts])
    return torch.as_tensor(host, dtype=dtype, device=device)


def increment_scale(sim, kind, U, t, dt):
    """max|F_x|/dx + max|F_y|/dy + max|S|: the size of the terms a stage
    increment k of U cancels, which bounds its roundoff.  Computed by the
    plain pipeline on U's device (a check's yardstick, not a main-path
    call)."""
    from pyro2_tpu_torch.mesh.indexer import ai
    from pyro2_tpu_torch.solvers.compressible import get_external_sources
    from pyro2_tpu_torch.solvers.compressible_rk.simulation import _floored

    myg = sim.cc_data.grid
    rp, ivars = sim.rp, sim.ivars
    U = _floored(U, rp.get_param("compressible.small_dens"), ivars, myg)
    ps = sim.problem_source

    class _Data:
        grid = myg

    if kind == "rk":
        from pyro2_tpu_torch.solvers.compressible_rk import fluxes
        F_x, F_y = fluxes.fluxes(U, _Data(), rp, ivars, sim.solid, sim.tc,
                                 sim.domain_edges.flags())
        S = get_external_sources(t, dt, U, ivars, rp, myg, problem_source=ps)
    else:
        from pyro2_tpu_torch.mesh.fv import to_centers_array
        from pyro2_tpu_torch.solvers.compressible_fv4 import fluxes
        F_x, F_y = fluxes.fluxes(U, _Data(), rp, ivars)
        S = get_external_sources(t, dt, to_centers_array(U, myg), ivars, rp,
                                 myg, problem_source=ps)
    return (float(ai(F_x, myg).v(buf=(0, 1, 0, 0)).abs().max()) / myg.dx +
            float(ai(F_y, myg).v(buf=(0, 0, 0, 1)).abs().max()) / myg.dy +
            float(ai(S, myg).v(buf=1).abs().max()))


class MOLSubstep:
    """substep(U, t, dt) -> k for a live compressible_rk (kind "rk") or
    compressible_fv4 / compressible_sdc (kind "fv4") Simulation."""

    def __init__(self, sim, kind):
        if kind not in KINDS:
            raise ValueError(f"unknown MOL kernel kind {kind}")
        rp = sim.rp
        myg = sim.cc_data.grid
        ivars = sim.ivars
        if not 4 <= ivars.nvar <= MAXVAR:
            raise NotImplementedError(
                f"the MOL kernels take 4..{MAXVAR} variables, not "
                f"{ivars.nvar} (ROADMAP.md A.22)")
        if myg.ng != 4:
            raise NotImplementedError(
                f"the MOL kernels take 4 ghost cells, not {myg.ng} "
                "(ROADMAP.md A.22)")
        riemann = 2        # fv4 always solves CGF on primitive states
        covered(ivars)
        # fv4 has no well-balanced reconstruction
        well_balanced = kind == "rk" and \
            bool(rp.get_param("compressible.well_balanced"))
        if kind == "rk":
            method = rp.get_param("compressible.riemann")
            if method not in RIEMANN:
                raise ValueError(f"unknown Riemann solver {method}")
            riemann = RIEMANN[method]

        self.sim = sim
        self.kind = kind
        self.plain = sim._make_substep()
        self.shape = (ivars.nvar, myg.qx, myg.qy)
        self.small_dens = rp.get_param("compressible.small_dens")
        self.spherical = getattr(myg, "coord_type", 0) == 1
        self.problem = sim.problem_source is not None
        self.well_balanced = well_balanced
        self.extended = self.spherical or self.problem or well_balanced
        self._lines = {}     # the spherical lines buffer by dtype, device
        s = sim.solid
        # the fv4 pipeline clamps no walls (riemann_prim with solid 0, 0)
        walls = [s.xl, s.xr, s.yl, s.yr] if kind == "rk" else [0, 0, 0, 0]
        gamma = rp.get_param("eos.gamma")
        self._ints = [ivars.nvar, myg.nx, myg.ny, myg.ng,
                      ivars.idens, ivars.ixmom, ivars.iymom, ivars.iener,
                      riemann, rp.get_param("compressible.limiter"),
                      int(bool(rp.get_param("compressible.use_flattening"))),
                      1,  # gravity sources: always added, as the plain
                          # version adds its (zero when grav = 0) S stack
                      int(bool(rp.get_param("sponge.do_sponge"))),
                      0,  # has_floor, set per dtype
                      *walls,
                      int(self.spherical), int(self.problem),
                      int(well_balanced),
                      # rk's viscosity: the domain-edge flags (all 1 on a
                      # serial grid, 0 on a sharded block's seams); the fv4
                      # pipeline reads none
                      *((int(e) for e in sim.domain_edges.flags())
                        if kind == "rk" else (0, 0, 0, 0))]
        # the host-side constants are rounded in double, as the plain
        # version's Python floats are
        self._doubles = [myg.dx, myg.dy, 0.0,  # dt, set per call
                         gamma,
                         rp.get_param("compressible.z0"),
                         rp.get_param("compressible.z1"),
                         rp.get_param("compressible.delta"),
                         rp.get_param("compressible.cvisc"),
                         0.0,  # floor, set per dtype
                         rp.get_param("compressible.grav"),
                         rp.get_param("sponge.sponge_rho_begin"),
                         rp.get_param("sponge.sponge_rho_full"),
                         rp.get_param("sponge.sponge_timescale"),
                         myg.dx ** 2, myg.dy ** 2, myg.dx ** 2 / 24.0,
                         -myg.dx ** 2, ALPHA, BETA * gamma,
                         0.0]   # e_rate, set per call

    @property
    def name(self):
        return f"mol_{self.kind}"

    def check(self, U):
        """Raise on anything the kernel and its plain version do not take."""
        if not isinstance(U, torch.Tensor):
            raise TypeError("the MOL substep takes a torch.Tensor")
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

    def kernel_args(self, U, dt, e_rate=0.0):
        """(int parameters, double parameters) of one kernel call on U;
        the doubles end with the problem source's e_rate
        (simulation.energy_rate)."""
        floor_min = torch.finfo(U.dtype).min
        ints = list(self._ints)
        doubles = list(self._doubles)
        ints[13] = int(self.small_dens > floor_min)
        doubles[2] = float(dt)
        doubles[8] = max(self.small_dens, floor_min)
        doubles[19] = e_rate
        return ints, doubles

    def spherical_lines(self, U):
        """The spherical lines in U's dtype on its device (made once), or
        None on a Cartesian grid."""
        if not self.spherical:
            return None
        key = (U.dtype, U.device)
        if key not in self._lines:
            self._lines[key] = lines(self.sim.cc_data.grid, U.dtype,
                                     U.device)
        return self._lines[key]

    def launch(self, U, t, dt):
        """Launch the CUDA kernel on U's device and current stream.  The
        gravity source does not depend on t, so t is not passed."""
        self.check(U)
        e_rate, W = energy_rate(self.sim, U)
        if self.well_balanced and self._ints[9] != 1:
            # as the plain version's
            raise ValueError("well-balanced only works for limiter == 1")
        if U.device.type != "cuda":
            raise ValueError("the CUDA MOL kernel takes a CUDA tensor")
        ints, doubles = self.kernel_args(U, dt, e_rate)
        G = self.spherical_lines(U)

        lib = _load()
        k = torch.empty_like(U)
        suffix = "f32" if U.dtype == torch.float32 else "f64"
        fn = getattr(lib, f"mol_{self.kind}_substep_{suffix}")
        c_ints = (ctypes.c_int * len(ints))(*ints)
        c_doubles = (ctypes.c_double * len(doubles))(*doubles)
        if self.kind == "rk":
            # the extended instantiation reads its sources' inputs from
            # device memory and holds nothing more in shared memory
            tiles = rk_plan(ints[1], ints[2], self.shape[0], U.dtype,
                            flatten=bool(ints[10])).ints()
        else:
            tiles = plan(ints[1], ints[2], self.shape[0], U.dtype,
                         flatten=bool(ints[10]),
                         extended=self.extended).ints()
        args = (U.data_ptr(), None if G is None else G.data_ptr(),
                None if W is None else W.data_ptr(), k.data_ptr(), c_ints,
                c_doubles, (ctypes.c_int * len(tiles))(*tiles))
        with torch.cuda.device(U.device):
            stream = torch.cuda.current_stream(U.device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"MOL {self.kind} kernel launch failed: CUDA error {err}")
        launches[self.name] += 1
        return k
