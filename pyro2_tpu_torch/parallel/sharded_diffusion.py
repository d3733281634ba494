"""Crank-Nicolson diffusion over a mesh of ranks.

The port of pyro2_tpu/parallel/sharded_diffusion.py, the first solver on
the block-partitioned multigrid: each step builds this rank's block of the
C-N right-hand side f = phi + dt/2 k L phi through one halo exchange, then
solves (1 - dt/2 k L) phi' = f with one sharded multigrid solve
(parallel.sharded_mg, kernel structure).  It equals the serial solver to
roundoff, whatever the mesh.
"""

import importlib

import torch.nn.functional as F

from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.parallel.mesh_comm import halo_exchange
from pyro2_tpu_torch.parallel.sharded_mg import make_sharded_mg

__all__ = ["ShardedDiffusion"]


class ShardedDiffusion:
    """Block-partitioned C-N diffusion stepping.

    Holds this rank's (bx, by) block of the phi interior; `evolve` advances
    one implicit step (collective: every rank calls it).  The initial state
    and the dt rule come from the serial diffusion Simulation built on the
    same runtime parameters, on the mesh's device, in `dtype` (the
    device's working dtype by default)."""

    def __init__(self, rp, mesh, *, problem="gaussian", dtype=None):
        from pyro2_tpu_torch.solvers import diffusion

        problem_mod = importlib.import_module(
            f"pyro2_tpu_torch.solvers.diffusion.problems.{problem}")
        self.global_sim = diffusion.Simulation(
            "diffusion", problem, problem_mod.init_data, rp,
            device=mesh.device, dtype=dtype)
        self.global_sim.initialize()
        self.global_sim.method_compute_timestep()
        self.dt = self.global_sim.dt
        self.k = rp.get_param("diffusion.k")

        gg = self.global_sim.cc_data.grid
        self.grid = gg
        self.mesh = mesh
        self.bc = self.global_sim.cc_data.BCs["phi"]

        self.smg = make_sharded_mg(
            gg.nx, gg.ny, mesh,
            xmin=gg.xmin, xmax=gg.xmax, ymin=gg.ymin, ymax=gg.ymax,
            xl_BC_type=self.bc.xlb, xr_BC_type=self.bc.xrb,
            yl_BC_type=self.bc.ylb, yr_BC_type=self.bc.yrb,
            alpha=1.0, beta=0.5 * self.dt * self.k,
            dtype=self.global_sim.dtype)
        self.smg.init_solution(self.global_sim.cc_data.get_var("phi"))
        self.phi_int = self.smg.get_solution()
        self.t = 0.0
        self.n = 0

    def _rhs(self):
        """This rank's block of f = phi + dt/2 k L phi (one halo
        exchange)."""
        lg = self.smg.local_grids[self.smg.nlevels - 1]
        p = halo_exchange(F.pad(self.phi_int, (1, 1, 1, 1)), lg, self.bc,
                          self.mesh)
        pv = ai(p, lg)
        return pv.v() + 0.5 * self.dt * self.k * pv.lap()

    def evolve(self):
        """One C-N implicit step: the RHS, then one sharded MG solve."""
        rhs = self._rhs()
        # alpha and beta are read at every cycle, so a step that changes
        # them takes effect at once
        self.smg.serial.alpha = 1.0
        self.smg.serial.beta = 0.5 * self.dt * self.k
        self.smg.init_zeros()
        self.smg.init_RHS(rhs)
        self.smg.solve(rtol=1.e-10)
        self.phi_int = self.smg.get_solution()
        self.t += self.dt
        self.n += 1

    def get_phi(self):
        """This rank's (bx, by) block of the phi interior."""
        return self.phi_int

    def gather_phi(self):
        """The (nx, ny) global phi interior, on every rank."""
        return self.smg.gather_solution()
