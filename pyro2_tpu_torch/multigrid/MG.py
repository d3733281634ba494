"""Constant-coefficient cell-centered multigrid for (alpha - beta L) phi = f.

The port of pyro2_tpu/multigrid/MG.py, and the base class of the
coefficient forms (variable_coeff_MG.py, general_MG.py), which override
`_smooth_once` and `_residual` and keep their per-level coefficients in
the `aux` hooks:

* the level list (2x2 ... NxN, each a Grid2d) is fixed at construction and
  cached by configuration on the host, with the red/black colour masks, so
  the solvers that build a fresh MG object for every solve stay cheap;
* red-black Gauss-Seidel is two masked half-sweeps per iteration, with a
  ghost fill after each, and the bottom solve is nsmooth_bottom iterations
  on the 2x2 level;
* a V-cycle of the finest level runs through `mg_kernel.cycle`
  (downs -> core -> ups): the CUDA kernels for CUDA tensors, the plain
  versions, built from `_smooth_n`, `_residual` and the transfers here,
  for CPU tensors;
* `solve` is a host loop that reads the residual norm and the relative
  change once per cycle (one device sync), with the JAX package's
  convergence and stall rules.  Under BC values on CUDA it lifts them
  into the right-hand side once (`mg_kernel.kernel_rhs`) for all its
  cycles; the source norm, f and the residual it reports are the
  original f's;
* `multigrid.refine.solve_ir` drives `solve` for its corrections and
  leaves the low half of its double-f32 solution on `v_lo`.

Nothing here writes a tensor the caller handed in.
"""

import functools
import math

import numpy as np
import torch

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.defaults import dtype as working_dtype
from pyro2_tpu_torch.defaults import resolve_device
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.mesh.indexer import ai, embed, fill_ghost
from pyro2_tpu_torch.multigrid import mg_kernel
from pyro2_tpu_torch.util import msg, profile_pyro

__all__ = ["CellCenterMG2d", "stats"]

# solves and V-cycles run since the counts were last reset (read by
# chip_smoke.py beside the kernels' launch counts)
stats = {"solves": 0, "cycles": 0}


@functools.lru_cache(maxsize=32)
def _level_grids(nlevels, ng, xmin, xmax, ymin, ymax):
    """The Grid2d of each level, 2x2 first.  Every MG of this
    configuration in the process shares them, so their coordinate arrays
    are made read-only: an in-place write raises instead of corrupting
    the later solves."""
    grids = tuple(Grid2d(2 ** (i + 1), 2 ** (i + 1), ng=ng, xmin=xmin,
                         xmax=xmax, ymin=ymin, ymax=ymax)
                  for i in range(nlevels))
    for g in grids:
        for a in vars(g).values():
            if isinstance(a, np.ndarray):
                a.setflags(write=False)
    return grids


@functools.lru_cache(maxsize=128)
def _shared_color_masks(g, device):
    ii = torch.arange(g.qx, device=device)[:, None] - g.ilo
    jj = torch.arange(g.qy, device=device)[None, :] - g.jlo
    interior = (ii >= 0) & (ii < g.nx) & (jj >= 0) & (jj < g.ny)
    red = ((ii + jj) % 2 == 0) & interior
    black = ((ii + jj) % 2 == 1) & interior
    return red, black


def _color_masks(g, device):
    """(red, black) masks of a level: (i-ilo)+(j-jlo) even / odd over the
    interior only, so ghost cells are never selected.  Copies of the
    cached pair: a caller may write into them without touching any other
    MG's masks."""
    red, black = _shared_color_masks(g, device)
    return red.clone(), black.clone()


class _MGDataShim:
    """Minimal CellCenterData2d stand-in for extended-BC dispatch on the
    MG solution variable."""

    def __init__(self, grid):
        self.grid = grid
        self.names = ["v"]
        self.aux = {}
        self.t = 0.0

    def get_aux(self, key):
        return self.aux.get(key, None)


class CellCenterMG2d:
    """Multigrid solve of (alpha - beta L) phi = f on a square 2^m grid.

    `device` defaults to CUDA (raising when there is none) and `dtype` to
    the device's working dtype, as for the solvers."""

    def __init__(self, nx, ny, ng=1,
                 xmin=0.0, xmax=1.0, ymin=0.0, ymax=1.0,
                 xl_BC_type="dirichlet", xr_BC_type="dirichlet",
                 yl_BC_type="dirichlet", yr_BC_type="dirichlet",
                 xl_BC=None, xr_BC=None, yl_BC=None, yr_BC=None,
                 alpha=0.0, beta=-1.0,
                 nsmooth=10, nsmooth_bottom=50,
                 verbose=0, aux_field=None, aux_bc=None,
                 true_function=None, *, device=None, dtype=None):
        if nx != ny:
            raise ValueError("ERROR: multigrid currently requires nx = ny")
        if (xmax - xmin) != (ymax - ymin):
            raise ValueError(
                "ERROR: multigrid currently requires a square domain")

        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device, dtype)

        self.nx = nx
        self.ny = ny
        self.ng = ng
        self.xmin, self.xmax = xmin, xmax
        self.ymin, self.ymax = ymin, ymax

        self.alpha = float(alpha)
        self.beta = float(beta)
        self.nsmooth = nsmooth
        self.nsmooth_bottom = nsmooth_bottom
        self.max_cycles = 100
        self.verbose = verbose
        self.true_function = true_function

        self.small = 1.e-16
        self.initialized_rhs = 0

        # levels: index 0 is the 2x2 coarsest, nlevels-1 the finest
        self.nlevels = int(math.log(self.nx) / math.log(2.0))
        self.grids = list(_level_grids(self.nlevels, ng, float(xmin),
                                       float(xmax), float(ymin),
                                       float(ymax)))

        # the v-variable BC per level: the finest may be inhomogeneous,
        # the coarse levels (which hold corrections) are homogeneous
        self.bc = bnd.BC(xlb=xl_BC_type, xrb=xr_BC_type,
                         ylb=yl_BC_type, yrb=yr_BC_type)
        self.bc_v = [self.bc] * (self.nlevels - 1)
        self.bc_v.append(bnd.BC(xlb=xl_BC_type, xrb=xr_BC_type,
                                ylb=yl_BC_type, yrb=yr_BC_type,
                                xl_func=xl_BC, xr_func=xr_BC,
                                yl_func=yl_BC, yr_func=yr_BC,
                                grid=self.grids[-1]))

        # per-level state: the finest level's (coarse levels live inside a
        # cycle; `smooth` allocates them on demand)
        self.v = [None] * (self.nlevels - 1) + [self._zeros(-1)]
        self.f = [None] * (self.nlevels - 1) + [self._zeros(-1)]
        self.r = [None] * (self.nlevels - 1) + [self._zeros(-1)]

        # aux fields (hooks for the coefficient subclasses): one frame per
        # level and name, and each name's BC
        self.aux = {name: [self._zeros(lv) for lv in range(self.nlevels)]
                    for name in aux_field or []}
        self.aux_bc = dict(zip(aux_field or [], aux_bc or []))

        # solution-mesh conveniences
        soln_grid = self.grids[self.nlevels - 1]
        self.soln_grid = soln_grid
        self.ilo, self.ihi = soln_grid.ilo, soln_grid.ihi
        self.jlo, self.jhi = soln_grid.jlo, soln_grid.jhi
        self.x, self.dx, self.x2d = soln_grid.x, soln_grid.dx, soln_grid.x2d
        self.y, self.dy, self.y2d = soln_grid.y, soln_grid.dy, soln_grid.y2d

        self.source_norm = 0.0
        self.num_cycles = 0
        self.residual_error = 1.e33
        self.relative_error = 1.e33
        # the low half of solve_ir's solution v[-1] + v_lo
        self.v_lo = None

    def _zeros(self, level):
        return self.grids[level].scratch_array(dtype=self.dtype,
                                               device=self.device)

    def _as_frame(self, data, what):
        data = torch.as_tensor(data, dtype=self.dtype, device=self.device)
        expect = (self.soln_grid.qx, self.soln_grid.qy)
        if tuple(data.shape) != expect:
            raise ValueError(
                f"{what} shape {tuple(data.shape)} does not match the MG "
                f"solution grid {expect} (build it on mg.soln_grid)")
        return data.contiguous()

    # ------------------------------------------------------------------
    # state initialization / access
    # ------------------------------------------------------------------
    def init_solution(self, data):
        """Set the initial guess for phi on the finest level."""
        self.v[-1] = self._as_frame(data, "solution")

    def init_zeros(self):
        """Zero the initial guess."""
        self.v[-1] = self._zeros(-1)

    def init_RHS(self, data):
        """Set the RHS f on the finest level and record its norm."""
        self.f[-1] = self._as_frame(data, "RHS")
        self.source_norm = profile_pyro.read(
            ai(self.f[-1], self.soln_grid).norm(), "source_norm")
        if self.verbose:
            print("Source norm = ", self.source_norm)
        self.initialized_rhs = 1

    def get_solution(self, grid=None):
        """The solution phi (optionally copied onto a same-spacing grid)."""
        v = self.v[-1]
        if grid is None:
            return v
        myg = self.soln_grid
        assert grid.dx == myg.dx and grid.dy == myg.dy
        sol = grid.scratch_array(dtype=self.dtype, device=self.device)
        sol[grid.ilo - 1:grid.ihi + 2, grid.jlo - 1:grid.jhi + 2] = \
            ai(v, myg).v(buf=1)
        return sol

    def get_solution_gradient(self, grid=None):
        """Centered-difference gradient of the solution, (gx, gy)."""
        myg = self.soln_grid
        og = grid if grid is not None else myg
        assert og.dx == myg.dx and og.dy == myg.dy

        vv = ai(self.v[-1], myg)
        gx = og.scratch_array(dtype=self.dtype, device=self.device)
        gy = og.scratch_array(dtype=self.dtype, device=self.device)
        gx[og.ilo:og.ihi + 1, og.jlo:og.jhi + 1] = \
            0.5 * (vv.ip(1) - vv.ip(-1)) / myg.dx
        gy[og.ilo:og.ihi + 1, og.jlo:og.jhi + 1] = \
            0.5 * (vv.jp(1) - vv.jp(-1)) / myg.dy
        return gx, gy

    def get_solution_object(self):
        """A CellCenterData2d view of the finest level (v, f, r)."""
        from pyro2_tpu_torch.mesh.patch import CellCenterData2d
        d = CellCenterData2d(self.soln_grid, dtype=self.dtype,
                             device=self.device)
        d.register_var("v", self.bc_v[-1])
        d.register_var("f", self.bc)
        d.register_var("r", self.bc)
        d.create()
        d.set_var("v", self.v[-1])
        d.set_var("f", self.f[-1])
        d.set_var("r", self.r[-1])
        return d

    def grid_info(self, level, indent=0):
        print("{}level: {}, grid: {} x {}".format(
            indent * " ", level, self.grids[level].nx, self.grids[level].ny))

    # ------------------------------------------------------------------
    # the numeric core (the plain versions of the kernels are built from
    # these; none of them writes its inputs)
    # ------------------------------------------------------------------
    def _fill_v(self, level, v):
        """Fill v's ghosts in place (standard kinds, then any extended BC
        registered with define_bc); returns v."""
        fill_ghost(v, self.grids[level], self.bc_v[level])
        bc = self.bc_v[level]
        for edge in ("xlb", "xrb", "ylb", "yrb"):
            btype = getattr(bc, edge)
            if btype in bnd.ext_bcs:
                shim = _MGDataShim(self.grids[level])
                v = bnd.ext_bcs[btype](btype, edge, "v", shim, v[None])[0]
        return v

    def _residual(self, level, v, f):
        """r = f - alpha v + beta L v over the valid region (ghosts zero)."""
        g = self.grids[level]
        vv = ai(v, g)
        lap = ((vv.ip(-1) + vv.ip(1) - 2.0 * vv.v()) / g.dx ** 2 +
               (vv.jp(-1) + vv.jp(1) - 2.0 * vv.v()) / g.dy ** 2)
        return embed(ai(f, g).v() - self.alpha * vv.v() + self.beta * lap,
                     g)

    def _smooth_once(self, level, v, f):
        """One red-black Gauss-Seidel iteration (ghosts filled on entry)."""
        g = self.grids[level]
        xcoeff = self.beta / g.dx ** 2
        ycoeff = self.beta / g.dy ** 2
        denom = self.alpha + 2.0 * xcoeff + 2.0 * ycoeff
        red, black = _color_masks(g, v.device)

        def half_sweep(v, mask):
            vv = ai(v, g)
            # compute the GS update everywhere, select the color set
            upd = (ai(f, g).v() +
                   xcoeff * (vv.ip(1) + vv.ip(-1)) +
                   ycoeff * (vv.jp(1) + vv.jp(-1))) / denom
            return torch.where(mask, embed(upd, g), v)

        v = self._fill_v(level, half_sweep(v, red))
        return self._fill_v(level, half_sweep(v, black))

    def _smooth_n(self, level, v, f, n):
        v = self._fill_v(level, v.clone())
        for _ in range(n):
            v = self._smooth_once(level, v, f)
        return v

    def smooth(self, level, nsmooth):
        """Public smoothing entry (used by tests and examples)."""
        if self.v[level] is None:
            self.v[level] = self._zeros(level)
            self.f[level] = self._zeros(level)
        self.v[level] = self._smooth_n(level, self.v[level], self.f[level],
                                       nsmooth)

    def _v_cycle(self, level, v, f):
        """The plain recursive V-cycle of levels 0..level."""
        if level > 0:
            v, f_c = mg_kernel.down_plain(self, level, v, f)
            v_c = self._v_cycle(level - 1, torch.zeros_like(f_c), f_c)
            v, _ = mg_kernel.up_plain(self, level, v, f, v_c, want_r=False)
            return v
        # bottom solve: just smooth the 2x2 problem hard
        v = self._smooth_n(level, v, f, self.nsmooth_bottom)
        return self._fill_v(level, v)

    # ------------------------------------------------------------------
    # driver
    # ------------------------------------------------------------------
    def solve(self, rtol=1.e-11):
        """V-cycle until ||r||/||f|| < rtol (or max_cycles, or two stalled
        cycles in a row), in a span `mg.solve` with a span `mg.cycle` for
        each cycle."""
        with profile_pyro.span("mg.solve"):
            self._solve(rtol)

    def _solve(self, rtol):
        if not self.initialized_rhs:
            msg.fail("ERROR: RHS not initialized")

        if self.verbose:
            print("source norm = ", self.source_norm)

        g = self.soln_grid
        v, f = self.v[-1], self.f[-1]
        f_h = mg_kernel.kernel_rhs(self, f)

        residual_error = 1.e33
        relative_error = 1.e33
        cycle = 1
        n_stalled = 0
        while residual_error > rtol and cycle <= self.max_cycles:
            with profile_pyro.span("mg.cycle"):
                v_new, r = mg_kernel.cycle(self, v, f, f_h)
                # the one device read of the cycle: residual norm and change
                rnorm, relative_error = profile_pyro.read(torch.stack([
                    ai(r, g).norm(),
                    ai((v_new - v) / (v_new + self.small), g).norm()]),
                    "norms")
            v = v_new
            self.r[-1] = r

            prev_residual_error = residual_error
            if self.source_norm != 0.0:
                residual_error = rnorm / self.source_norm
            else:
                residual_error = rnorm

            if self.verbose:
                print(f"cycle {cycle}: relative err = {relative_error}, "
                      f"residual err = {residual_error}\n")
            cycle += 1

            # stall detection: at the working dtype's roundoff floor the
            # residual stops contracting (ratio ~1); a healthy V-cycle
            # contracts ~10x/cycle, so two consecutive near-flat cycles
            # mean further work is wasted (float32 never reaches the
            # float64-calibrated rtol the solvers pass)
            if residual_error > 0.95 * prev_residual_error:
                n_stalled += 1
                if n_stalled >= 2:
                    if self.verbose:
                        print(f"MG stalled at residual err "
                              f"{residual_error:.3e} (cycle {cycle - 1}); "
                              "at the working-precision floor")
                    break
            else:
                n_stalled = 0

        self.num_cycles = cycle - 1
        self.relative_error = relative_error
        self.residual_error = residual_error
        if self.num_cycles == 0:
            v = v.clone()
        self.v[-1] = self._fill_v(self.nlevels - 1, v)
        stats["solves"] += 1
        stats["cycles"] += self.num_cycles
