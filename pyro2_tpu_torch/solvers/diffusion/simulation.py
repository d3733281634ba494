"""Crank-Nicolson diffusion Simulation.

The port of pyro2_tpu/solvers/diffusion/simulation.py.  Each step solves
(1 - dt/2 k L) phi^{n+1} = phi^n + dt/2 k L phi^n with the multigrid
Helmholtz solver (alpha = 1, beta = dt k / 2), whose V-cycles run through
the CUDA multigrid kernels on the GPU.
"""

import math

from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.multigrid import MG
from pyro2_tpu_torch.simulation_null import (NullSimulation, bc_setup,
                                             grid_setup)
from pyro2_tpu_torch.util import msg, profile_pyro


class Simulation(NullSimulation):
    """A simulation of diffusion."""

    def initialize(self):
        """Grid (ng=1, power-of-2 square), the "phi" variable, ICs."""
        my_grid = grid_setup(self.rp, ng=1)

        if my_grid.nx != my_grid.ny:
            msg.fail("need nx = ny for diffusion problems")
        n = int(math.log(my_grid.nx) / math.log(2.0))
        if 2 ** n != my_grid.nx:
            msg.fail("grid needs to be a power of 2")

        bc, _, _ = bc_setup(self.rp)
        for bnd_t in [bc.xlb, bc.xrb, bc.ylb, bc.yrb]:
            if bnd_t not in ["periodic", "neumann", "dirichlet"]:
                msg.fail("invalid BC")

        my_data = self.data_class(my_grid)
        my_data.register_var("phi", bc)
        my_data.create()
        self.cc_data = my_data

        self.problem_func(self.cc_data, self.rp)

    def method_compute_timestep(self):
        """dt = cfl * min(dx^2/k, dy^2/k) (explicit constraint as baseline)."""
        cfl = self.rp.get_param("driver.cfl")
        k = self.rp.get_param("diffusion.k")
        xtmp = self.cc_data.grid.dx ** 2 / k
        ytmp = self.cc_data.grid.dy ** 2 / k
        self.dt = cfl * min(xtmp, ytmp)

    def evolve(self):
        """One C-N implicit step: MG solve of the Helmholtz system."""
        self.cc_data.fill_BC_all()
        phi = self.cc_data.get_var("phi")
        myg = self.cc_data.grid

        k = self.rp.get_param("diffusion.k")
        bcs = self.cc_data.BCs["phi"]

        with profile_pyro.span("mg.setup"):
            mg = MG.CellCenterMG2d(myg.nx, myg.ny,
                                   xmin=myg.xmin, xmax=myg.xmax,
                                   ymin=myg.ymin, ymax=myg.ymax,
                                   xl_BC_type=bcs.xlb, xr_BC_type=bcs.xrb,
                                   yl_BC_type=bcs.ylb, yr_BC_type=bcs.yrb,
                                   alpha=1.0, beta=0.5 * self.dt * k,
                                   verbose=0, device=self.device,
                                   dtype=self.dtype)

        # RHS: f = phi + dt/2 k L phi, and its norm's read
        with profile_pyro.span("rhs"):
            pv = ai(phi, myg)
            f = mg.soln_grid.scratch_array(dtype=self.dtype,
                                           device=self.device)
            f[mg.ilo:mg.ihi + 1, mg.jlo:mg.jhi + 1] = \
                pv.v() + 0.5 * self.dt * k * pv.lap()
            mg.init_RHS(f)
        mg.init_zeros()
        mg.solve(rtol=1.e-10)

        # the interior takes the solution; phi's ghosts stay as filled
        sol = mg.get_solution()
        phi[myg.ilo:myg.ihi + 1, myg.jlo:myg.jhi + 1] = \
            ai(sol, mg.soln_grid).v()

        self.cc_data.t += self.dt
        self.n += 1

    def dovis(self):
        from pyro2_tpu_torch.util import plot_tools
        plot_tools.plot_fields(
            self, [("phi", self.cc_data.get_var("phi"))], title="phi")
