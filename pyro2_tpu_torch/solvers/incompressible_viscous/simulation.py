"""Viscous incompressible Simulation: the projection method with viscous
interface sources and a Crank-Nicolson parabolic velocity update (the
port of pyro2_tpu/solvers/incompressible_viscous/simulation.py).

Each step runs four multigrid solves on the constant operator: the MAC
and the final projection of the incompressible solver, and between them
one Crank-Nicolson solve per velocity component.  On CUDA every V-cycle
goes through the multigrid kernels, the cavity's moving lid included
(multigrid/mg_kernel.py takes it as a ghost-zero edge).
"""

import torch

from pyro2_tpu_torch.mesh import boundary as bnd
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.multigrid import MG
from pyro2_tpu_torch.solvers import incompressible
from pyro2_tpu_torch.solvers.incompressible_viscous import BC


class Simulation(incompressible.Simulation):

    def initialize(self):  # pylint: disable=arguments-differ
        """Same as incompressible, plus the moving_lid BC and viscosity."""
        nu = self.rp.get_param("incompressible_viscous.viscosity")
        super().initialize(other_bc=True, aux_vars=(("viscosity", nu),))

    def define_other_bc(self):
        bnd.define_bc("moving_lid", BC.user, is_solid=False)

    def evolve(self):  # pylint: disable=arguments-differ
        """The projection steps with viscous source + parabolic update."""
        super().evolve(other_update_velocity=True, other_source_term=True)

    def other_source_term(self):
        """The viscous source nu L U."""
        myg = self.cc_data.grid
        nu = self.rp.get_param("incompressible_viscous.viscosity")
        u = self.cc_data.get_var("x-velocity")
        v = self.cc_data.get_var("y-velocity")

        sl = (slice(myg.ilo, myg.ihi + 1), slice(myg.jlo, myg.jhi + 1))
        source_x = torch.zeros_like(u)
        source_x[sl] = nu * ai(u, myg).lap()
        source_y = torch.zeros_like(v)
        source_y[sl] = nu * ai(v, myg).lap()
        return source_x, source_y

    def do_other_update_velocity(self, U_MAC, U_INT):
        """Replace the advective velocity update with two decoupled C-N
        parabolic multigrid solves (one per component)."""
        if self.verbose > 0:
            print("  doing parabolic solve for u, v")

        myg = self.cc_data.grid
        nu = self.rp.get_param("incompressible_viscous.viscosity")
        proj_type = self.rp.get_param("incompressible.proj_type")
        dt = self.dt

        u = self.cc_data.get_var("x-velocity")
        v = self.cc_data.get_var("y-velocity")
        gradp_x = self.cc_data.get_var("gradp_x")
        gradp_y = self.cc_data.get_var("gradp_y")

        u_MAC, v_MAC = U_MAC
        u_xint, u_yint, v_xint, v_yint = U_INT

        um = ai(u_MAC, myg)
        vm = ai(v_MAC, myg)
        uxi = ai(u_xint, myg)
        vxi = ai(v_xint, myg)
        uyi = ai(u_yint, myg)
        vyi = ai(v_yint, myg)

        advect_x = (0.5 * (um.v() + um.ip(1)) * (uxi.ip(1) - uxi.v()) /
                    myg.dx +
                    0.5 * (vm.v() + vm.jp(1)) * (uyi.jp(1) - uyi.v()) /
                    myg.dy)
        advect_y = (0.5 * (um.v() + um.ip(1)) * (vxi.ip(1) - vxi.v()) /
                    myg.dx +
                    0.5 * (vm.v() + vm.jp(1)) * (vyi.jp(1) - vyi.v()) /
                    myg.dy)

        def parabolic_solve(w, advect_w, gradp_w, bcs):
            mg = MG.CellCenterMG2d(myg.nx, myg.ny,
                                   xmin=myg.xmin, xmax=myg.xmax,
                                   ymin=myg.ymin, ymax=myg.ymax,
                                   xl_BC_type=bcs.xlb, xr_BC_type=bcs.xrb,
                                   yl_BC_type=bcs.ylb, yr_BC_type=bcs.yrb,
                                   alpha=1.0, beta=0.5 * dt * nu, verbose=0,
                                   device=self.device, dtype=self.dtype)
            f_v = ai(w, myg).v() + 0.5 * dt * nu * ai(w, myg).lap()
            if proj_type == 1:
                f_v = f_v - dt * (advect_w + ai(gradp_w, myg).v())
            elif proj_type == 2:
                f_v = f_v - dt * advect_w
            f = mg.soln_grid.scratch_array(dtype=self.dtype,
                                           device=self.device)
            f[mg.ilo:mg.ihi + 1, mg.jlo:mg.jhi + 1] = f_v
            mg.init_RHS(f)
            guess = mg.soln_grid.scratch_array(dtype=self.dtype,
                                               device=self.device)
            guess[mg.ilo - 1:mg.ihi + 2, mg.jlo - 1:mg.jhi + 2] = \
                ai(w, myg).v(buf=1)
            mg.init_solution(guess)
            mg.solve(rtol=1.e-12)
            sol = mg.get_solution()
            w_new = w.clone()
            w_new[myg.ilo:myg.ihi + 1, myg.jlo:myg.jhi + 1] = \
                ai(sol, mg.soln_grid).v()
            return w_new

        u_new = parabolic_solve(u, advect_x, gradp_x,
                                self.cc_data.BCs["x-velocity"])
        v_new = parabolic_solve(v, advect_y, gradp_y,
                                self.cc_data.BCs["y-velocity"])
        self.cc_data.set_var("x-velocity", u_new)
        self.cc_data.set_var("y-velocity", v_new)

    def write_extras(self, f):
        """Record the custom-BC name (restart support)."""
        gb = f.create_group("BC")
        gb.create_dataset("moving_lid", data=False)
