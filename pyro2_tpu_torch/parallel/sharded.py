"""Compressible and shallow-water CTU steps over a mesh of ranks.

The port of pyro2_tpu/parallel/sharded.py.  The single-block solver steps
are blind to how their ghost cells were filled, so a sharded step is: pad
this rank's block of the interior -> halo exchange (the neighbours'
strips, and the physical fills on the blocks that own a domain edge) ->
the SAME block step on the padded block -> the updated interior.  One
rank owns one block of a `mesh_comm.Mesh` (`launch.run` starts the ranks
of a larger mesh; `make_mesh()` without a process group is the 1 x 1 mesh
one card runs), and every method that steps or reduces is collective:
every rank calls it.

Nothing global is ever built:

* the problem's initial conditions are evaluated block by block on block
  grids whose coordinates equal the global grid's window bit for bit
  (parallel/blocks.py);
* dt is the solver's CFL rule on each block reduced with `Mesh.pmin`,
  which equals the serial global minimum exactly;
* the solid-wall Riemann clamps and the artificial viscosity's domain
  edges are the block's own: a rank knows its coordinates, so only the
  blocks that own a domain edge clamp there, and a seam's high face takes
  its viscosity from the halo (compressible/simulation.py DomainEdges,
  plain ints in the block-local Simulation; the JAX package traces them
  from axis_index).

Extended BCs (hse, ambient, ramp; compressible/BC.py) run after the
per-variable standard exchange, on the ranks that own that domain edge.
A fill that reads coordinates (the ramp) sees a grid holding the block's
bitwise-global coordinates.  The in-step ghost fill of the source stack
(aux_data.fill_bc_stack) is replaced by a gated fill with no exchange:
the sources are pointwise functions of the exchanged state, so their seam
ghosts already hold the serial values and only the domain edges need the
physical fills.  A positive density floor (compressible.small_dens) is
applied to the seam halos as well, where the serial grid's floor reaches
those cells as interior ones.

The block-local Simulation's grid is made this rank's block grid
(blocks.adopt_block_grid): the global dx and dy, which a grid built from
the block's own extents can miss by an ulp, and coordinates equal to the
global grid's window bit for bit.  In spherical geometry its geometry
arrays are the block's window of the global grid's float64 planes and
lines (not recomputed from the block's coordinates), and so is the CUDA
kernel's geometry buffer (ctu_kernel.geometry of the block grid).

The block step on CUDA is the block-local Simulation's kernel wrapper:
`CTUStep` (`k_ctu`, with the block's solid and edge flags, row 1 of
PERF.md section 6) or `SWEStep` (`k_swe`, row 5), one launch a rank a
step through the host-dt entry; for the method-of-lines solvers, whose
stage loops sharded_mol.py runs on this class, it is the stage increment
`MOLSubstep` (`k_rk` with the block's solid and edge flags, or `k_fv4`;
rows 6a and 6b).  It launches or raises.  Two JAX routes
are not carried over: the TPU `try`/`except` that falls back to the jnp
block step when the fused kernel fails to build (a CUDA failure here
raises), and `_build_fused`, the second route through the periodic-frame
kernel (row 2), which covers only a subset of configurations, where row 1
with its flags covers every one.  On the CPU the block step is the plain
step with the same flags.

`overlap=True` (compressible and swe) steps through
overlap.build_overlapped_step: the block step on the unfilled padded block
while the first split axis's halo messages are in flight, then four band
steps on the filled block's rims; it equals the plain sharded step bit
for bit.

Refused, as in JAX: a grid that does not divide over the mesh, BCs other
than the standard kinds and the registered extended ones, problems with
`source_terms`, extended BCs or spherical geometry with `overlap`, blocks
narrower than 4 ng with `overlap`, and extended BCs on a spherical grid.
"""

import importlib

import torch
import torch.nn.functional as F

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.parallel.blocks import (adopt_block_grid,
                                             blockwise_init_interior,
                                             gather_interior)
from pyro2_tpu_torch.parallel.mesh_comm import (gated_physical_fill,
                                                halo_exchange_stack,
                                                seam_exchange)
from pyro2_tpu_torch.util.runparams import RuntimeParameters

__all__ = ["ShardedSim", "ShardedCompressible", "ShardedSWE",
           "make_sharded_compressible_step"]

_SUPPORTED_BCS = frozenset(
    ["outflow", "neumann", "dirichlet", "reflect", "reflect-odd",
     "reflect-even", "periodic"])

_EDGES = ("xl", "xr", "yl", "yr")


class _BCData:
    """The stand-in of a CellCenterData2d that an extended BC fill sees:
    the block grid with bitwise-global coordinates, the names, the aux
    values and the time."""

    def __init__(self, grid, names, aux, t):
        self.grid = grid
        self.names = list(names)
        self.aux = aux
        self.t = 0.0 if t is None else t

    def get_aux(self, key):
        return self.aux.get(key)


class ShardedSim:
    """A solver's CTU step over a mesh of ranks.

    Builds a block-local Simulation (the same runtime parameters, this
    rank's block dimensions and its solid and edge flags) on the mesh's
    device in `dtype` (the device's working dtype by default); halo
    exchange replaces the serial ghost fill.  States are this rank's
    (nvar, bx, by) block of the interior."""

    _SOLVERS = ("compressible", "swe", "compressible_rk",
                "compressible_fv4", "compressible_sdc")

    def __init__(self, solver, rp, mesh, *, problem="test", ng=4,
                 overlap=False, dtype=None):
        if solver not in self._SOLVERS:
            raise ValueError(
                f"solver '{solver}' has no sharded step "
                f"(supported: {sorted(self._SOLVERS)})")
        self.solver = solver
        self._solver_mod = importlib.import_module(
            f"pyro2_tpu_torch.solvers.{solver}")
        self.rp = rp
        self.problem = problem
        self._problem_mod = importlib.import_module(
            f"pyro2_tpu_torch.solvers.{solver}.problems.{problem}")
        # problem-parameter layering (pyro_sim's initialize_problem):
        # PROBLEM_PARAMS are defaults, the caller's values win
        for k, v in getattr(self._problem_mod, "PROBLEM_PARAMS",
                            {}).items():
            if k not in rp.params:
                rp.set_param(k, v, no_new=False)

        self.mesh = mesh
        self.px, self.py = mesh.px, mesh.py
        self.nx, self.ny = rp.get_param("mesh.nx"), rp.get_param("mesh.ny")

        # the block-local simulation whose step runs on each block.  Its
        # problem init is a no-op (the initial state is made block by
        # block), and its grid becomes this rank's block grid below
        self.local_sim = self._solver_mod.Simulation(
            solver, problem, lambda d, r: None, block_params(rp, mesh),
            device=mesh.device, dtype=dtype)
        self.local_sim.initialize(ng=ng)
        self.dtype = self.local_sim.dtype

        self.local_grid = self.local_sim.cc_data.grid
        self.names = list(self.local_sim.cc_data.names)
        self.bcs = [self.local_sim.cc_data.BCs[n] for n in self.names]
        self.nvar = len(self.bcs)
        self.ng = ng

        # BCs are validated after the local initialize, which registers
        # the solver's extended ones
        ext_used = False
        for edge in _EDGES:
            b = rp.get_param(f"mesh.{edge}boundary")
            if b in bnd.ext_bcs:
                ext_used = True
            elif b not in _SUPPORTED_BCS:
                raise ValueError(
                    f"boundary '{b}' is not supported by the sharded "
                    "path (it would silently mis-fill block seams)")
        self._has_ext = ext_used
        if getattr(self._problem_mod, "source_terms", None) is not None:
            raise ValueError(
                "problems with source_terms (global-coordinate heating) "
                "have no sharded step")
        self._spherical = getattr(self.local_grid, "coord_type", 0) == 1
        if self._spherical and ext_used:
            raise ValueError("extended BCs are not supported with "
                             "spherical geometry in the sharded path")

        # the block grid: the global dx and dy, bitwise-global coordinates
        # (for the extended fills too) and geometry
        adopt_block_grid(self.local_grid, rp, mesh)
        if self._spherical:
            self._window_geometry()
        self._owns = {e + "b": o for e, o in zip(_EDGES, mesh.owned_edges)}
        self._base_solid = self.local_sim.solid
        self._floor_mask = self._seam_floor_mask()
        # the block step, built with the block's flags and geometry
        self._block_step = self.local_step(self.local_sim, mesh.owned_edges)
        self.local_sim._step = self._block_step
        self._dt_fn = self.local_sim._make_dt()
        self._global_sim = None
        self._overlapped = None
        if overlap:
            from pyro2_tpu_torch.parallel.overlap import build_overlapped_step
            self._overlapped = build_overlapped_step(self)

    def local_step(self, sim, owns):
        """The step of a block-local Simulation `sim` (this rank's block,
        or an overlap band of it) with the solid and domain-edge flags of
        the domain edges in `owns` (xl, xr, yl, yr: the Mesh's
        owned_edges, or a band's): solid walls clamp and the viscosity
        stops only there, and the in-step source ghost fill is gated the
        same way,
        with no exchange.  The kernel wrapper (CTUStep or SWEStep, or
        MOLSubstep's stage increment for the method-of-lines solvers),
        which runs the plain step for CPU tensors."""
        own = dict(zip(_EDGES, owns))
        base = self._base_solid
        sim.solid = bnd.BCProp(
            *(getattr(base, e) if own[e] else 0 for e in _EDGES))
        if hasattr(sim, "domain_edges"):
            sim.domain_edges = type(sim.domain_edges)(
                *(int(own[e]) for e in _EDGES))
        if hasattr(sim, "aux_data"):
            sim.aux_data.fill_bc_stack = self._gated_stack_fill(
                sim.aux_data, sim.cc_data.grid, owns)
        if self.solver == "swe":
            from pyro2_tpu_torch.solvers.swe.swe_kernel import SWEStep
            return SWEStep(sim)
        return sim._make_kernel_step()

    # -- the block's geometry, fills and floor ------------------------------
    def _window_geometry(self):
        """Point the block grid's spherical geometry at this block's window
        of the global grid's float64 arrays (the serial grid's, exactly,
        where numpy's transcendental functions on the block's own
        coordinates need not be)."""
        from pyro2_tpu_torch.mesh.grid import SphericalPolar
        rp = self.rp
        gg = SphericalPolar(self.nx, self.ny, ng=self.ng,
                            xmin=rp.get_param("mesh.xmin"),
                            xmax=rp.get_param("mesh.xmax"),
                            ymin=rp.get_param("mesh.ymin"),
                            ymax=rp.get_param("mesh.ymax"))
        g = self.local_grid
        rows = slice(self.mesh.ix * g.nx, self.mesh.ix * g.nx + g.qx)
        cols = slice(self.mesh.iy * g.ny, self.mesh.iy * g.ny + g.qy)
        for name in ("Lx", "Ly", "Ax", "Ay", "dlogAx", "dlogAy", "V"):
            setattr(g, name, getattr(gg, name)[rows, cols])
        for name in ("sin_yl", "sin_y", "sin_yb"):
            setattr(g, name, getattr(gg, name)[cols])

    def _apply_ext_fills(self, cc, bcs, names, U, t):
        """The extended fills of a stack, on the edges this rank owns, in
        the serial fill's variable-then-edge order (patch.py
        _fill_var)."""
        data = _BCData(self.local_grid, cc.names, cc.aux, t)
        for n, name in enumerate(names):
            for edge in ("xlb", "xrb", "ylb", "yrb"):
                btype = getattr(bcs[n], edge)
                if btype in bnd.ext_bcs and self._owns[edge]:
                    U = bnd.ext_bcs[btype](btype, edge, name, data, U)
        return U

    def _gated_stack_fill(self, aux_cc, g, owns):
        """A fill_bc_stack for a source stack whose ghosts are pointwise
        functions of the exchanged state: seam ghosts keep their pointwise
        values (what the serial fill leaves there) and only the blocks
        that own a domain edge (in `owns`) apply the physical and extended
        fills."""
        names = list(aux_cc.names)
        bcs = [aux_cc.BCs[n] for n in names]

        def fill(stack, t=None):
            stack = torch.stack([gated_physical_fill(stack[n], g, bc, owns)
                                 for n, bc in enumerate(bcs)])
            if self._has_ext:
                stack = self._apply_ext_fills(aux_cc, bcs, names, stack, t)
            return stack

        return fill

    def _fill_local(self, U, t=None):
        """The halo exchange of a padded block (each variable with its own
        BC), then the extended fills on the owning ranks."""
        U = halo_exchange_stack(U, self.local_grid, self.bcs, self.mesh)
        if self._has_ext:
            U = self._apply_ext_fills(self.local_sim.cc_data, self.bcs,
                                      self.names, U, t)
        return U

    def _seam_floor_mask(self):
        """The density floor's cells of the padded block: those of the
        global interior, seam halos included (the serial grid floors them
        as interior cells; the block step floors its own interior), or
        None without a positive floor."""
        if self.solver == "swe":
            return None
        small_dens = self.rp.get_param("compressible.small_dens")
        if not small_dens > torch.finfo(self.dtype).min:
            return None
        g = self.local_grid
        dev = self.mesh.device
        gi = torch.arange(g.qx, device=dev) + self.mesh.ix * g.nx - g.ng
        gj = torch.arange(g.qy, device=dev) + self.mesh.iy * g.ny - g.ng
        return (((gi >= 0) & (gi < self.nx))[:, None] &
                ((gj >= 0) & (gj < self.ny))[None, :])

    def _padded(self, U_int, t):
        """The filled padded block of an interior block."""
        ng = self.ng
        return self._fill_local(F.pad(U_int, (ng, ng, ng, ng)), t)

    def _step_input(self, U_int, t):
        """The padded block the block step takes: filled, and with the
        density floor on the seam halos."""
        return self._floor_seams(self._padded(U_int, t))

    def _floor_seams(self, U):
        """A filled padded block with the density floor on the seam halos
        (a copy; U itself without a positive floor).  The block step
        floors its interior again, which changes nothing."""
        if self._floor_mask is None:
            return U
        iv = self.local_sim.ivars
        floor = self.rp.get_param("compressible.small_dens")
        U = U.clone()
        U[iv.idens] = torch.where(self._floor_mask,
                                  U[iv.idens].clamp_min(floor),
                                  U[iv.idens])
        return U

    def _interior(self, U):
        ng = self.ng
        return U[:, ng:-ng, ng:-ng].contiguous()

    # -- public API ---------------------------------------------------------
    def init_interior(self):
        """This rank's (nvar, bx, by) block of the problem's initial
        state, initialized block by block (nothing global is built)."""
        return blockwise_init_interior(self.local_sim.cc_data,
                                       self._problem_mod.init_data,
                                       self.rp, self.mesh, dtype=self.dtype)

    @property
    def global_sim(self):
        """A global serial Simulation of the same problem on the mesh's
        device (built lazily; for the tests, never used by the sharded
        path)."""
        if self._global_sim is None:
            self._global_sim = self._solver_mod.Simulation(
                self.solver, self.problem, self._problem_mod.init_data,
                self.rp, device=self.mesh.device, dtype=self.dtype)
            self._global_sim.initialize(ng=self.ng)
        return self._global_sim

    def global_interior(self):
        """This rank's block of the global serial simulation's interior."""
        gs = self.global_sim
        g = gs.cc_data.grid
        bx, by = self.local_grid.nx, self.local_grid.ny
        i0 = g.ilo + self.mesh.ix * bx
        j0 = g.jlo + self.mesh.iy * by
        return gs.cc_data.data[:, i0:i0 + bx, j0:j0 + by].contiguous()

    def gather(self, U_int):
        """The (nvar, nx, ny) global interior from every rank's block, on
        every rank (collective)."""
        return gather_interior(U_int, self.mesh)

    def compute_dt(self, U_int):
        """The CFL dt: the blocks' CFL minima reduced with Mesh.pmin
        (equal to the serial global minimum)."""
        cfl = self.rp.get_param("driver.cfl")
        d = self._dt_fn(self._padded(U_int, None))
        return cfl * float(self.mesh.pmin(d))

    def step(self, U_int, t, dt):
        """One sharded step of this rank's (nvar, bx, by) interior block
        (t, dt: host floats); with `overlap`, the overlapped step."""
        if self._overlapped is not None:
            return self._overlapped(U_int, t, dt)
        return self._interior(self._block_step(self._step_input(U_int, t),
                                               t, dt))

    def build_step_with_particles(self, particles):
        """A step(U_int, pos, active, t, dt) -> (U_int', pos', active'):
        the sharded step, then the replicated particle advance with the
        post-step velocities.  As in the serial evolve, the domain ghosts
        are stale from the pre-step fill; the seam halos are refreshed
        from the neighbours' post-step interiors, which the serial grid
        holds there (one seam exchange of u and v).

        `particles` is a serial global-grid Particles (geometry, BCs, edge
        enforcement); its positions and `active` are the replicated
        carries."""
        from pyro2_tpu_torch.driver_loop import _particle_velocity_fn
        from pyro2_tpu_torch.parallel.sharded_particles import \
            make_sharded_particle_advance
        adv = make_sharded_particle_advance(particles, self.local_grid,
                                            self.mesh)
        vel = _particle_velocity_fn(self.local_sim)

        def step(U_int, pos, active, t, dt):
            U = self._block_step(self._step_input(U_int, t), t, dt)
            uv = seam_exchange(torch.stack(vel(U)), self.local_grid,
                               self.mesh)
            pos, active = adv(pos, active, uv[0], uv[1], dt)
            return self._interior(U), pos, active

        return step


class ShardedCompressible(ShardedSim):
    def __init__(self, rp, mesh, *, problem="test", ng=4, overlap=False,
                 dtype=None):
        super().__init__("compressible", rp, mesh, problem=problem, ng=ng,
                         overlap=overlap, dtype=dtype)


class ShardedSWE(ShardedSim):
    def __init__(self, rp, mesh, *, problem="test", ng=4, overlap=False,
                 dtype=None):
        super().__init__("swe", rp, mesh, problem=problem, ng=ng,
                         overlap=overlap, dtype=dtype)


def block_params(rp, mesh):
    """The runtime parameters of this rank's block-local Simulation: a copy
    of rp with the block's shape, the domain's low corner and the block's
    extent from it (adopt_block_grid then gives the block grid the global
    spacing and coordinates), and no particles (the global ones are
    replicated; a random set would draw from numpy's global generator).
    Raises ValueError if the grid does not divide over the mesh."""
    nx, ny = rp.get_param("mesh.nx"), rp.get_param("mesh.ny")
    if nx % mesh.px != 0 or ny % mesh.py != 0:
        raise ValueError("grid must divide evenly over the device mesh")
    bx, by = nx // mesh.px, ny // mesh.py
    local_rp = RuntimeParameters()
    local_rp.params = dict(rp.params)
    local_rp.param_comments = dict(rp.param_comments)
    local_rp.set_param("mesh.nx", bx)
    local_rp.set_param("mesh.ny", by)
    xmin, xmax = rp.get_param("mesh.xmin"), rp.get_param("mesh.xmax")
    ymin, ymax = rp.get_param("mesh.ymin"), rp.get_param("mesh.ymax")
    local_rp.set_param("mesh.xmax", xmin + (xmax - xmin) * bx / nx)
    local_rp.set_param("mesh.ymax", ymin + (ymax - ymin) * by / ny)
    local_rp.set_param("particles.do_particles", 0, no_new=False)
    return local_rp


def make_sharded_compressible_step(rp, mesh, *, problem="test", ng=4,
                                   dtype=None):
    """Convenience constructor returning a ShardedCompressible."""
    return ShardedCompressible(rp, mesh, problem=problem, ng=ng, dtype=dtype)
