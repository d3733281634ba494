"""The incompressible solvers over a mesh of ranks.

The port of pyro2_tpu/parallel/sharded_incompressible.py.  One rank owns
one block of the (6, nx, ny) interior (x-velocity, y-velocity, phi-MAC,
phi, gradp_x, gradp_y) and runs the serial step's stages on its padded
block: the limited slopes, the MAC velocities, the interface states and the
advective update are the serial tensor code on the block grid, and the
elliptic solves run inline through `ShardedMG.solve_local` (global norms,
the coarse levels gathered and solved alike on every rank).  A step has
two of them, the MAC and the final projection, and `preevolve` a third,
the initial projection on periodic edges; the viscous solver adds one
Crank-Nicolson solve per velocity component between the projections.
Nothing global is built:

* the initial state is evaluated block by block on block grids whose
  coordinates equal the global grid's window bit for bit
  (parallel/blocks.py);
* dt is the serial CFL rule on block maxima taken over the whole padded
  block, ghosts included, as the serial rule reads the whole padded
  array, reduced with `Mesh.pmax`, which equals the serial maximum
  exactly;
* a step returns the (6, bx, by) interior; the next step fills its ghosts
  by halo exchange, as the serial driver's fill_BC_all does.

The sharded solves sum their norms over the ranks, which may round
differently from the serial sums, so a run equals the serial one to
roundoff; everything else is the serial arithmetic.

On CUDA every solve is `mg_deep_smooth`, `mg_correct` and `mg_core`
(rows 18, 19 and 8 of PERF.md section 6: make_sharded_mg's kernel
structure), with no second route; on the CPU the same structure runs their
plain versions.  The operator is set on each solver's serial object before
each solve (alpha 0, beta -1 for the projections, alpha 1, beta = dt nu / 2
for the Crank-Nicolson solves), as ShardedDiffusion does.

Refused, as in JAX: a grid that does not divide over the mesh, and any BC
the sharded multigrid does not take, the cavity's moving lid among them.
"""

import importlib

import torch
import torch.nn.functional as F

from pyro2_tpu_torch.mesh import reconstruction
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.parallel.blocks import (adopt_block_grid,
                                             blockwise_init_interior,
                                             gather_interior)
from pyro2_tpu_torch.parallel.mesh_comm import (halo_exchange,
                                                halo_exchange_stack)
from pyro2_tpu_torch.parallel.sharded import block_params
from pyro2_tpu_torch.parallel.sharded_mg import (_SUPPORTED_BCS,
                                                 make_sharded_mg)
from pyro2_tpu_torch.solvers.incompressible import incomp_interface

__all__ = ["ShardedIncompressible", "ShardedIncompressibleViscous"]


def block_simulation(solver, problem, rp, mesh, dtype):
    """A block-sized Simulation of `solver` on this rank's block grid (the
    global dx and dy, bitwise-global coordinates), whose problem init is a
    no-op, and the problem's module; the problem's PROBLEM_PARAMS are
    layered under the caller's values in rp first."""
    problem_mod = importlib.import_module(
        f"pyro2_tpu_torch.solvers.{solver}.problems.{problem}")
    for k, v in getattr(problem_mod, "PROBLEM_PARAMS", {}).items():
        if k not in rp.params:
            rp.set_param(k, v, no_new=False)
    local_rp = block_params(rp, mesh)
    solver_mod = importlib.import_module(f"pyro2_tpu_torch.solvers.{solver}")
    sim = solver_mod.Simulation(solver, problem, lambda d, r: None, local_rp,
                                device=mesh.device, dtype=dtype)
    sim.initialize()
    adopt_block_grid(sim.cc_data.grid, rp, mesh)
    cc = sim.cc_data
    for name in cc.names:
        bc = cc.BCs[name]
        for kind in (bc.xlb, bc.xrb, bc.ylb, bc.yrb):
            if kind not in _SUPPORTED_BCS:
                raise ValueError(
                    f"BC '{kind}' is not supported by the sharded {solver} "
                    "path")
    return sim, problem_mod


def mg_for(bc, rp, mesh, dtype, **kw):
    """A sharded multigrid (kernel structure) on the global grid of rp with
    the edges of `bc` (a BC, or one kind for all four)."""
    kinds = (bc,) * 4 if isinstance(bc, str) else (bc.xlb, bc.xrb, bc.ylb,
                                                   bc.yrb)
    return make_sharded_mg(
        rp.get_param("mesh.nx"), rp.get_param("mesh.ny"), mesh,
        xmin=rp.get_param("mesh.xmin"), xmax=rp.get_param("mesh.xmax"),
        ymin=rp.get_param("mesh.ymin"), ymax=rp.get_param("mesh.ymax"),
        xl_BC_type=kinds[0], xr_BC_type=kinds[1], yl_BC_type=kinds[2],
        yr_BC_type=kinds[3], dtype=dtype, **kw)


def solve_inline(smg, v0, f, rtol, alpha=None, beta=None):
    """One sharded solve of (alpha - beta L) phi = f on this rank's
    (bx+2, by+2) blocks: the guess v0 and the right-hand side f (its ghost
    ring unread); alpha and beta are set on the serial object first (None
    for a coefficient operator, whose own planes hold it).  The source
    norm is global, as the serial init_RHS's.  Returns the (bx+2, by+2)
    solution with depth-1 valid ghosts."""
    if alpha is not None:
        smg.serial.alpha = alpha
        smg.serial.beta = beta
    g = smg.soln_grid
    ss = smg.mesh.psum(torch.sum(f[1:-1, 1:-1] ** 2))
    sn = float(torch.sqrt(g.dx * g.dy * ss))
    return smg.solve_local(v0, f, rtol, sn)[0]


def cfl_dt(u, v, g, mesh, cfl, small=1.e-12):
    """The serial CFL rule cfl min(dx / max|u|, dy / max|v|) (burgers'
    method_compute_timestep) over every rank's filled padded blocks u and
    v, ghosts included, the maxima reduced with Mesh.pmax."""
    umax, vmax = mesh.pmax(torch.stack([u.abs().max(),
                                        v.abs().max()])).tolist()
    return cfl * min(g.dx / max(umax, small), g.dy / max(vmax, small))


class ShardedIncompressible:
    """Block-partitioned approximate-projection incompressible flow.

    `U_int` is this rank's (6, bx, by) block of the interior, on the mesh's
    device in `dtype` (its working dtype by default).  The driver methods
    mirror the serial Simulation's (method_compute_timestep, preevolve,
    evolve) and are collective.  Subclass hooks mirror the serial
    other_source_term and do_other_update_velocity: `_viscous_sources` and
    `_update_velocity`."""

    SMALL = 1.e-12
    _SOLVER = "incompressible"

    def __init__(self, rp, mesh, *, problem="shear", dtype=None):
        self.rp = rp
        self.mesh = mesh
        self.px, self.py = mesh.px, mesh.py
        self.local_sim, problem_mod = block_simulation(
            self._SOLVER, problem, rp, mesh, dtype)
        self.dtype = self.local_sim.dtype
        self.nx, self.ny = rp.get_param("mesh.nx"), rp.get_param("mesh.ny")
        cc = self.local_sim.cc_data
        self.names = list(cc.names)
        self.bcs = [cc.BCs[n] for n in self.names]
        self.lg4 = cc.grid
        self.iu = self.names.index("x-velocity")
        self.iv = self.names.index("y-velocity")
        self.ipm = self.names.index("phi-MAC")
        self.iph = self.names.index("phi")
        self.igx = self.names.index("gradp_x")
        self.igy = self.names.index("gradp_y")

        self.smg = mg_for(cc.BCs["phi"], rp, mesh, self.dtype)
        # the initial projection always uses periodic phi BCs
        self.smg_init = mg_for("periodic", rp, mesh, self.dtype)
        self.lg1 = self.smg.local_grids[self.smg.nlevels - 1]

        self.U_int = blockwise_init_interior(cc, problem_mod.init_data, rp,
                                             mesh, dtype=self.dtype)
        self.limiter = rp.get_param("incompressible.limiter")
        self.proj_type = rp.get_param("incompressible.proj_type")
        self.cfl = rp.get_param("driver.cfl")
        self.t = 0.0
        self.n = 0
        self.dt = None

    # -- the block's fills ---------------------------------------------------
    def _filled(self, U_int):
        """The padded block of an interior block, every variable's ghosts
        filled by halo exchange (the serial driver's fill_BC_all)."""
        ng = self.lg4.ng
        return halo_exchange_stack(F.pad(U_int, (ng, ng, ng, ng)), self.lg4,
                                   self.bcs, self.mesh)

    def _valid(self):
        g = self.lg4
        return (slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))

    def _poisson(self, smg, v0, f, rtol):
        return solve_inline(smg, v0, f, rtol, 0.0, -1.0)

    # -- subclass hooks -------------------------------------------------------
    def _viscous_sources(self, u, v):
        return None, None

    def _update_velocity(self, u, v, advect_x, advect_y, gradp_x, gradp_y,
                         dt):
        """The provisional velocity update: advective, and with proj_type 1
        the lagged pressure gradient."""
        sl = self._valid()
        u = u.clone()
        v = v.clone()
        u[sl] += -dt * advect_x
        v[sl] += -dt * advect_y
        if self.proj_type == 1:
            u = u - dt * gradp_x
            v = v - dt * gradp_y
        return u, v

    # -- the step -------------------------------------------------------------
    def _step(self, U_int, dt):
        """One projection-method step of this rank's interior block."""
        g = self.lg4
        ng = g.ng
        dx, dy = g.dx, g.dy
        sl = self._valid()
        U = self._filled(U_int)
        u, v = U[self.iu], U[self.iv]
        gradp_x, gradp_y = U[self.igx], U[self.igy]
        phi = U[self.iph]

        ldelta_ux = reconstruction.limit(u, g, 1, self.limiter)
        ldelta_vx = reconstruction.limit(v, g, 1, self.limiter)
        ldelta_uy = reconstruction.limit(u, g, 2, self.limiter)
        ldelta_vy = reconstruction.limit(v, g, 2, self.limiter)

        source_x, source_y = self._viscous_sources(u, v)
        u_MAC, v_MAC = incomp_interface.mac_vels(
            g, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy,
            gradp_x, gradp_y, source_x, source_y)

        # the MAC projection: the edge-centred divergence
        um, vm = ai(u_MAC, g), ai(v_MAC, g)
        f = F.pad((um.ip(1) - um.v()) / dx + (vm.jp(1) - vm.v()) / dy,
                  (1, 1, 1, 1))
        phi_MAC = F.pad(self._poisson(self.smg, torch.zeros_like(f), f,
                                      1.e-12), (ng - 1,) * 4)
        # subtract the edge-centred gradient on all domain edges
        pm = ai(phi_MAC, g)
        u_MAC = u_MAC.clone()
        v_MAC = v_MAC.clone()
        u_MAC[g.ilo:g.ihi + 2, g.jlo:g.jhi + 1] -= \
            (pm.v(buf=(0, 1, 0, 0)) - pm.ip(-1, buf=(0, 1, 0, 0))) / dx
        v_MAC[g.ilo:g.ihi + 1, g.jlo:g.jhi + 2] -= \
            (pm.v(buf=(0, 0, 0, 1)) - pm.jp(-1, buf=(0, 0, 0, 1))) / dy

        # the full interface states and the provisional update
        u_xint, v_xint, u_yint, v_yint = incomp_interface.states(
            g, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy,
            gradp_x, gradp_y, u_MAC, v_MAC, source_x, source_y)
        um, vm = ai(u_MAC, g), ai(v_MAC, g)
        uxi, vxi = ai(u_xint, g), ai(v_xint, g)
        uyi, vyi = ai(u_yint, g), ai(v_yint, g)
        advect_x = (0.5 * (um.v() + um.ip(1)) * (uxi.ip(1) - uxi.v()) / dx +
                    0.5 * (vm.v() + vm.jp(1)) * (uyi.jp(1) - uyi.v()) / dy)
        advect_y = (0.5 * (um.v() + um.ip(1)) * (vxi.ip(1) - vxi.v()) / dx +
                    0.5 * (vm.v() + vm.jp(1)) * (vyi.jp(1) - vyi.v()) / dy)
        u, v = self._update_velocity(u, v, advect_x, advect_y, gradp_x,
                                     gradp_y, dt)
        u = halo_exchange(u, g, self.bcs[self.iu], self.mesh)
        v = halo_exchange(v, g, self.bcs[self.iv], self.mesh)

        # the final projection: the cell-centred divergence over dt
        uv, vv = ai(u, g), ai(v, g)
        f = F.pad((0.5 * (uv.ip(1) - uv.ip(-1)) / dx +
                   0.5 * (vv.jp(1) - vv.jp(-1)) / dy) / dt, (1, 1, 1, 1))
        phi_n = self._poisson(self.smg, phi[ng - 1:-(ng - 1),
                                            ng - 1:-(ng - 1)], f, 1.e-12)
        gphi_x, gphi_y = self._gradient(phi_n)
        u = u.clone()
        v = v.clone()
        u[sl] += -dt * gphi_x
        v[sl] += -dt * gphi_y
        if self.proj_type == 1:
            gradp_x = gradp_x.clone()
            gradp_y = gradp_y.clone()
            gradp_x[sl] += gphi_x
            gradp_y[sl] += gphi_y
        else:
            gradp_x = torch.zeros_like(gradp_x)
            gradp_y = torch.zeros_like(gradp_y)
            gradp_x[sl] = gphi_x
            gradp_y[sl] = gphi_y

        U = U.clone()
        U[self.iu], U[self.iv] = u, v
        U[self.ipm] = phi_MAC
        U[self.iph] = F.pad(phi_n, (ng - 1,) * 4)
        U[self.igx], U[self.igy] = gradp_x, gradp_y
        return U[:, ng:-ng, ng:-ng].contiguous()

    def _gradient(self, phi1):
        """The centred gradient of a (bx+2, by+2) solution block."""
        pv = ai(phi1, self.lg1)
        return (0.5 * (pv.ip(1) - pv.ip(-1)) / self.lg4.dx,
                0.5 * (pv.jp(1) - pv.jp(-1)) / self.lg4.dy)

    def _preproj(self, U_int):
        """The preevolve's initial projection: the velocity made
        divergence-free, periodic phi edges."""
        g = self.lg4
        ng = g.ng
        sl = self._valid()
        U = self._filled(U_int)
        u, v = U[self.iu].clone(), U[self.iv].clone()
        uv, vv = ai(u, g), ai(v, g)
        f = F.pad(0.5 * (uv.ip(1) - uv.ip(-1)) / g.dx +
                  0.5 * (vv.jp(1) - vv.jp(-1)) / g.dy, (1, 1, 1, 1))
        phi0 = self._poisson(self.smg_init, torch.zeros_like(f), f, 1.e-10)
        gx, gy = self._gradient(phi0)
        u[sl] -= gx
        v[sl] -= gy
        U[self.iu], U[self.iv] = u, v
        U[self.iph] = F.pad(phi0, (ng - 1,) * 4)
        return U[:, ng:-ng, ng:-ng].contiguous()

    # -- the driver (the serial Simulation's) ---------------------------------
    def method_compute_timestep(self):
        """CFL: dt = cfl min(dx / max|u|, dy / max|v|), the maxima over
        every padded block reduced with Mesh.pmax."""
        U = self._filled(self.U_int)
        self.dt = cfl_dt(U[self.iu], U[self.iv], self.lg4, self.mesh,
                         self.cfl, self.SMALL)

    def preevolve(self):
        """The initial projection, then one throwaway step for gradp at
        n - 1/2, of which only gradp is kept."""
        self.U_int = self._preproj(self.U_int)
        self.method_compute_timestep()
        evolved = self._step(self.U_int, self.dt)
        U = self.U_int.clone()
        U[self.igx] = evolved[self.igx]
        U[self.igy] = evolved[self.igy]
        self.U_int = U

    def evolve(self):
        self.U_int = self._step(self.U_int, self.dt)
        self.t += self.dt
        self.n += 1

    def get_var(self, name):
        """This rank's (bx, by) block of one variable's interior."""
        return self.U_int[self.names.index(name)]

    def gather(self):
        """The (6, nx, ny) global interior, on every rank (collective)."""
        return gather_interior(self.U_int, self.mesh)


class ShardedIncompressibleViscous(ShardedIncompressible):
    """Block-partitioned viscous incompressible flow: the projection method
    with the viscous sources nu L U and the two Crank-Nicolson velocity
    solves inline, one sharded multigrid per velocity component's BCs.
    Standard velocity BCs only: the cavity's moving lid raises."""

    _SOLVER = "incompressible_viscous"

    def __init__(self, rp, mesh, *, problem="shear", dtype=None):
        super().__init__(rp, mesh, problem=problem, dtype=dtype)
        self.nu = rp.get_param("incompressible_viscous.viscosity")
        self.smg_u = mg_for(self.bcs[self.iu], rp, mesh, self.dtype,
                            alpha=1.0, beta=1.0)
        self.smg_v = mg_for(self.bcs[self.iv], rp, mesh, self.dtype,
                            alpha=1.0, beta=1.0)

    def _global_interior_mask(self, shape, buf):
        """True where a cell of the block's buf-wide window is a cell of
        the global interior (the serial sources are zero outside it)."""
        g = self.lg4
        dev = self.mesh.device
        gi = torch.arange(shape[0], device=dev) - buf + self.mesh.ix * g.nx
        gj = torch.arange(shape[1], device=dev) - buf + self.mesh.iy * g.ny
        return (((gi >= 0) & (gi < self.nx))[:, None] &
                ((gj >= 0) & (gj < self.ny))[None, :])

    def _viscous_sources(self, u, v):
        """nu L U, nonzero exactly on the global interior: the seam halos
        the interface states read hold the serial grid's interior values
        there, the domain edges' ghosts zero."""
        g = self.lg4
        b = 2
        lap_u = ai(u, g).lap(buf=b)
        lap_v = ai(v, g).lap(buf=b)
        m = self._global_interior_mask(lap_u.shape, b)
        sl = (slice(g.ilo - b, g.ihi + 1 + b), slice(g.jlo - b, g.jhi + 1 + b))
        source_x = torch.zeros_like(u)
        source_x[sl] = torch.where(m, self.nu * lap_u, 0.0)
        source_y = torch.zeros_like(v)
        source_y[sl] = torch.where(m, self.nu * lap_v, 0.0)
        return source_x, source_y

    def _update_velocity(self, u, v, advect_x, advect_y, gradp_x, gradp_y,
                         dt):
        """Two decoupled Crank-Nicolson solves (the serial
        do_other_update_velocity), inline."""
        g = self.lg4
        ng = g.ng
        nu = self.nu
        sl = self._valid()

        def solve(smg, w, advect_w, gradp_w):
            f_v = ai(w, g).v() + 0.5 * dt * nu * ai(w, g).lap()
            if self.proj_type == 1:
                f_v = f_v - dt * (advect_w + ai(gradp_w, g).v())
            elif self.proj_type == 2:
                f_v = f_v - dt * advect_w
            sol = solve_inline(smg, w[ng - 1:-(ng - 1), ng - 1:-(ng - 1)],
                               F.pad(f_v, (1, 1, 1, 1)), 1.e-12, 1.0,
                               0.5 * dt * nu)
            w = w.clone()
            w[sl] = sol[1:-1, 1:-1]
            return w

        return (solve(self.smg_u, u, advect_x, gradp_x),
                solve(self.smg_v, v, advect_y, gradp_y))
