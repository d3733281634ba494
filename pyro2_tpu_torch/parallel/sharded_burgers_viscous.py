"""Viscous Burgers over a mesh of ranks.

The port of pyro2_tpu/parallel/sharded_burgers_viscous.py: the advective
stage of the serial solver (diffusion-corrected interface states,
transverse corrections, unsplit fluxes) runs on each rank's halo-exchanged
block, and the two Crank-Nicolson solves, one per velocity component,
(1 - dt/2 eps L) w = w + dt/2 eps L w - dt A, run inline through
`ShardedMG.solve_local` with alpha 1 and beta = dt eps / 2 set on the
solver before each (sharded_incompressible.solve_inline).  On CUDA every
solve is `mg_deep_smooth`, `mg_correct` and `mg_core`; the advective stage
is plain tensor code, as the serial solver's is.  The dt is the serial CFL
rule with Mesh.pmax.  A run equals the serial solver to roundoff (the
solves' norms are summed over the ranks).
"""

import torch
import torch.nn.functional as F

from pyro2_tpu_torch.mesh import reconstruction
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.parallel.blocks import (blockwise_init_interior,
                                             gather_interior)
from pyro2_tpu_torch.parallel.mesh_comm import halo_exchange_stack
from pyro2_tpu_torch.parallel.sharded_incompressible import (
    block_simulation, cfl_dt, mg_for, solve_inline)
from pyro2_tpu_torch.solvers.burgers import burgers_interface
from pyro2_tpu_torch.solvers.burgers_viscous import interface

__all__ = ["ShardedBurgersViscous"]


class ShardedBurgersViscous:
    """Block-partitioned viscous Burgers flow.  `U_int` is this rank's (2,
    bx, by) block of the interior (x-velocity, y-velocity) on the mesh's
    device in `dtype` (its working dtype by default); the driver methods
    are collective."""

    SMALL = 1.e-12

    def __init__(self, rp, mesh, *, problem="test", dtype=None):
        self.rp = rp
        self.mesh = mesh
        self.px, self.py = mesh.px, mesh.py
        self.local_sim, problem_mod = block_simulation(
            "burgers_viscous", problem, rp, mesh, dtype)
        self.dtype = self.local_sim.dtype
        cc = self.local_sim.cc_data
        self.names = list(cc.names)
        self.bcs = [cc.BCs[n] for n in self.names]
        self.lg4 = cc.grid
        self.iu = self.names.index("x-velocity")
        self.iv = self.names.index("y-velocity")
        self.smg = mg_for(self.bcs[self.iu], rp, mesh, self.dtype,
                          alpha=1.0, beta=1.0)
        self.U_int = blockwise_init_interior(cc, problem_mod.init_data, rp,
                                             mesh, dtype=self.dtype)
        self.limiter = rp.get_param("advection.limiter")
        self.eps = rp.get_param("diffusion.eps")
        self.cfl = rp.get_param("driver.cfl")
        self.t = 0.0
        self.n = 0
        self.dt = None

    def _filled(self, U_int):
        ng = self.lg4.ng
        return halo_exchange_stack(F.pad(U_int, (ng, ng, ng, ng)), self.lg4,
                                   self.bcs, self.mesh)

    def _step(self, U_int, dt):
        """One step of this rank's interior block."""
        g = self.lg4
        ng = g.ng
        eps = self.eps
        sl = (slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
        U = self._filled(U_int)
        u, v = U[self.iu], U[self.iv]

        ldelta_ux = reconstruction.limit(u, g, 1, self.limiter)
        ldelta_uy = reconstruction.limit(u, g, 2, self.limiter)
        ldelta_vx = reconstruction.limit(v, g, 1, self.limiter)
        ldelta_vy = reconstruction.limit(v, g, 2, self.limiter)
        states = burgers_interface.get_interface_states(
            g, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy)
        states = interface.apply_diffusion_corrections(g, dt, eps, u, v,
                                                       *states)
        states = burgers_interface.apply_transverse_corrections(g, dt,
                                                                *states)
        u_fx, u_fy, v_fx, v_fy = \
            burgers_interface.construct_unsplit_fluxes(g, *states)

        def advective(fx, fy):
            fx, fy = ai(fx, g), ai(fy, g)
            return (fx.ip(1) - fx.v()) / g.dx + (fy.jp(1) - fy.v()) / g.dy

        def cn_solve(w, A_v):
            """The serial interface.diffuse, inline."""
            f_v = (ai(w, g).v() + 0.5 * dt * eps *
                   ai(interface.get_lap(g, w), g).v() - dt * A_v)
            f = F.pad(f_v, (1, 1, 1, 1))
            sol = solve_inline(self.smg, torch.zeros_like(f), f, 1.e-12,
                               1.0, 0.5 * dt * eps)
            w = w.clone()
            w[sl] = sol[1:-1, 1:-1]
            return w

        U = U.clone()
        U[self.iu] = cn_solve(u, advective(u_fx, u_fy))
        U[self.iv] = cn_solve(v, advective(v_fx, v_fy))
        return U[:, ng:-ng, ng:-ng].contiguous()

    # -- the driver (the serial Simulation's) ---------------------------------
    def method_compute_timestep(self):
        U = self._filled(self.U_int)
        self.dt = cfl_dt(U[self.iu], U[self.iv], self.lg4, self.mesh,
                         self.cfl, self.SMALL)

    def evolve(self):
        self.U_int = self._step(self.U_int, self.dt)
        self.t += self.dt
        self.n += 1

    def get_var(self, name):
        """This rank's (bx, by) block of one variable's interior."""
        return self.U_int[self.names.index(name)]

    def gather(self):
        """The (2, nx, ny) global interior, on every rank (collective)."""
        return gather_interior(self.U_int, self.mesh)
