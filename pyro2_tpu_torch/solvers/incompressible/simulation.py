"""Incompressible Simulation: the 2nd-order approximate projection method.

The port of pyro2_tpu/solvers/incompressible/simulation.py.  The hyperbolic
stages (slopes, MAC velocities, interface states, advective update) are
plain tensor code; the elliptic solves (the initial projection in
preevolve, then the MAC and the final projection of every step) run on the
multigrid solver, whose V-cycles go through the CUDA multigrid kernels on
the GPU.
"""

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.mesh import patch, reconstruction
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.multigrid import MG
from pyro2_tpu_torch.simulation_null import bc_setup, grid_setup
from pyro2_tpu_torch.solvers.burgers import Simulation as burgers_simulation
from pyro2_tpu_torch.solvers.incompressible import incomp_interface


class Simulation(burgers_simulation):

    def initialize(self, *, other_bc=False, aux_vars=()):
        """Grid (ng=4), velocities + projection fields, ICs; `other_bc`
        registers a subclass's extended BCs first (define_other_bc)."""
        my_grid = grid_setup(self.rp, ng=4)
        my_data = self.data_class(my_grid)

        if other_bc:
            self.define_other_bc()

        bc, bc_xodd, bc_yodd = bc_setup(self.rp)

        my_data.register_var("x-velocity", bc_xodd)
        my_data.register_var("y-velocity", bc_yodd)

        # phi/gradp: Neumann when velocity is dirichlet (solid walls),
        # periodic when periodic
        if bc.xlb == "periodic":
            phi_bc = bc
        else:
            phi_bc = bnd.BC(xlb="neumann", xrb="neumann",
                            ylb="neumann", yrb="neumann")

        my_data.register_var("phi-MAC", phi_bc)
        my_data.register_var("phi", phi_bc)
        my_data.register_var("gradp_x", phi_bc)
        my_data.register_var("gradp_y", phi_bc)

        for v in aux_vars:
            my_data.set_aux(keyword=v[0], value=v[1])

        my_data.create()
        self.cc_data = my_data
        self.init_particles(bc)

        self.in_preevolve = False
        self.problem_func(self.cc_data, self.rp)

    # -- helpers ------------------------------------------------------------
    def _mg(self, bcs):
        """A multigrid Poisson solver on this grid, device and dtype."""
        myg = self.cc_data.grid
        return MG.CellCenterMG2d(myg.nx, myg.ny,
                                 xl_BC_type=bcs[0], xr_BC_type=bcs[1],
                                 yl_BC_type=bcs[2], yr_BC_type=bcs[3],
                                 xmin=myg.xmin, xmax=myg.xmax,
                                 ymin=myg.ymin, ymax=myg.ymax, verbose=0,
                                 device=self.device, dtype=self.dtype)

    def _proj_mg(self):
        bcs = self.cc_data.BCs["phi"]
        return self._mg((bcs.xlb, bcs.xrb, bcs.ylb, bcs.yrb))

    def _cc_divU(self, u, v, target_grid):
        """Cell-centered divergence, built on target_grid's padded shape
        (the MG solution grid has ng=1, unlike the ng=4 solver grid)."""
        myg = self.cc_data.grid
        uv = ai(u, myg)
        vv = ai(v, myg)
        divU = target_grid.scratch_array(dtype=self.dtype,
                                         device=self.device)
        divU[target_grid.ilo:target_grid.ihi + 1,
             target_grid.jlo:target_grid.jhi + 1] = \
            0.5 * (uv.ip(1) - uv.ip(-1)) / myg.dx + \
            0.5 * (vv.jp(1) - vv.jp(-1)) / myg.dy
        return divU

    def preevolve(self):
        """Initial projection (div U = 0) + one throwaway evolve to get
        gradp at n-1/2."""
        self.in_preevolve = True
        myg = self.cc_data.grid

        self.cc_data.fill_BC("x-velocity")
        self.cc_data.fill_BC("y-velocity")
        u = self.cc_data.get_var("x-velocity")
        v = self.cc_data.get_var("y-velocity")

        # the initial projection always uses periodic phi BCs
        mg = self._mg(("periodic",) * 4)
        mg.init_zeros()
        mg.init_RHS(self._cc_divU(u, v, mg.soln_grid))
        mg.solve(rtol=1.e-10)

        self.cc_data.set_var("phi", mg.get_solution(grid=myg))

        gradp_x, gradp_y = mg.get_solution_gradient(grid=myg)
        self.cc_data.set_var("x-velocity", u - gradp_x)
        self.cc_data.set_var("y-velocity", v - gradp_y)

        self.cc_data.fill_BC("x-velocity")
        self.cc_data.fill_BC("y-velocity")

        # evolve once to get gradp at n-1/2, then restore the state (the
        # clone copies the state tensor, which evolve writes in place)
        orig_data = patch.cell_center_data_clone(self.cc_data)
        self.method_compute_timestep()
        self.evolve()

        orig_data.set_var("gradp_x", self.cc_data.get_var("gradp_x"))
        orig_data.set_var("gradp_y", self.cc_data.get_var("gradp_y"))
        self.cc_data = orig_data

        if self.verbose > 0:
            print("done with the pre-evolution")
        self.in_preevolve = False

    def other_source_term(self):
        """Extra velocity sources (subclass hook); (source_x, source_y)."""
        return None, None

    def evolve(self, other_update_velocity=False, other_source_term=False):
        """One projection-method timestep."""
        myg = self.cc_data.grid
        dt = self.dt

        u = self.cc_data.get_var("x-velocity")
        v = self.cc_data.get_var("y-velocity")
        gradp_x = self.cc_data.get_var("gradp_x")
        gradp_y = self.cc_data.get_var("gradp_y")
        phi = self.cc_data.get_var("phi")

        if other_source_term:
            source_x, source_y = self.other_source_term()
        else:
            source_x, source_y = None, None

        limiter = self.rp.get_param("incompressible.limiter")

        ldelta_ux = reconstruction.limit(u, myg, 1, limiter)
        ldelta_vx = reconstruction.limit(v, myg, 1, limiter)
        ldelta_uy = reconstruction.limit(u, myg, 2, limiter)
        ldelta_vy = reconstruction.limit(v, myg, 2, limiter)

        # MAC velocities (normal velocities on cell edges)
        if self.verbose > 0:
            print("  making MAC velocities")
        u_MAC, v_MAC = incomp_interface.mac_vels(
            myg, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy,
            gradp_x, gradp_y, source_x, source_y)

        # --- MAC projection -------------------------------------------------
        if self.verbose > 0:
            print("  MAC projection")
        mg = self._proj_mg()

        um = ai(u_MAC, myg)
        vm = ai(v_MAC, myg)
        divU = mg.soln_grid.scratch_array(dtype=self.dtype,
                                          device=self.device)
        divU[mg.ilo:mg.ihi + 1, mg.jlo:mg.jhi + 1] = \
            (um.ip(1) - um.v()) / myg.dx + (vm.jp(1) - vm.v()) / myg.dy

        mg.init_zeros()
        mg.init_RHS(divU)
        mg.solve(rtol=1.e-12)

        solution = mg.get_solution()
        phi_MAC = self.cc_data.get_var("phi-MAC")
        phi_MAC[myg.ilo - 1:myg.ihi + 2, myg.jlo - 1:myg.jhi + 2] = \
            ai(solution, mg.soln_grid).v(buf=1)

        pm = ai(phi_MAC, myg)
        # subtract the edge-centered gradient on all domain edges
        u_MAC[myg.ilo:myg.ihi + 2, myg.jlo:myg.jhi + 1] -= \
            (pm.v(buf=(0, 1, 0, 0)) - pm.ip(-1, buf=(0, 1, 0, 0))) / myg.dx
        v_MAC[myg.ilo:myg.ihi + 1, myg.jlo:myg.jhi + 2] -= \
            (pm.v(buf=(0, 0, 0, 1)) - pm.jp(-1, buf=(0, 0, 0, 1))) / myg.dy

        # --- full interface states -----------------------------------------
        if self.verbose > 0:
            print("  making u, v edge states")
        u_xint, v_xint, u_yint, v_yint = incomp_interface.states(
            myg, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy,
            gradp_x, gradp_y, u_MAC, v_MAC, source_x, source_y)

        # --- provisional velocity update -----------------------------------
        proj_type = self.rp.get_param("incompressible.proj_type")

        if other_update_velocity:
            self.do_other_update_velocity((u_MAC, v_MAC),
                                          (u_xint, u_yint, v_xint, v_yint))
        else:
            if self.verbose > 0:
                print("  doing provisional update of u, v")
            um = ai(u_MAC, myg)
            vm = ai(v_MAC, myg)
            uxi = ai(u_xint, myg)
            vxi = ai(v_xint, myg)
            uyi = ai(u_yint, myg)
            vyi = ai(v_yint, myg)

            advect_x_v = (0.5 * (um.v() + um.ip(1)) *
                          (uxi.ip(1) - uxi.v()) / myg.dx +
                          0.5 * (vm.v() + vm.jp(1)) *
                          (uyi.jp(1) - uyi.v()) / myg.dy)
            advect_y_v = (0.5 * (um.v() + um.ip(1)) *
                          (vxi.ip(1) - vxi.v()) / myg.dx +
                          0.5 * (vm.v() + vm.jp(1)) *
                          (vyi.jp(1) - vyi.v()) / myg.dy)

            sl = (slice(myg.ilo, myg.ihi + 1), slice(myg.jlo, myg.jhi + 1))
            u_new = u.clone()
            v_new = v.clone()
            u_new[sl] += -dt * advect_x_v
            v_new[sl] += -dt * advect_y_v
            if proj_type == 1:
                u_new = u_new - dt * gradp_x
                v_new = v_new - dt * gradp_y

            self.cc_data.set_var("x-velocity", u_new)
            self.cc_data.set_var("y-velocity", v_new)

        self.cc_data.fill_BC("x-velocity")
        self.cc_data.fill_BC("y-velocity")
        u = self.cc_data.get_var("x-velocity")
        v = self.cc_data.get_var("y-velocity")

        # --- final projection ----------------------------------------------
        if self.verbose > 0:
            print("  final projection")
        mg = self._proj_mg()

        mg.init_RHS(self._cc_divU(u, v, mg.soln_grid) / dt)
        phiGuess = mg.soln_grid.scratch_array(dtype=self.dtype,
                                              device=self.device)
        phiGuess[mg.ilo - 1:mg.ihi + 2, mg.jlo - 1:mg.jhi + 2] = \
            ai(phi, myg).v(buf=1)
        mg.init_solution(phiGuess)
        mg.solve(rtol=1.e-12)

        self.cc_data.set_var("phi", mg.get_solution(grid=myg))

        gradphi_x, gradphi_y = mg.get_solution_gradient(grid=myg)

        self.cc_data.set_var("x-velocity", u - dt * gradphi_x)
        self.cc_data.set_var("y-velocity", v - dt * gradphi_y)

        if proj_type == 1:
            self.cc_data.set_var("gradp_x", gradp_x + gradphi_x)
            self.cc_data.set_var("gradp_y", gradp_y + gradphi_y)
        elif proj_type == 2:
            self.cc_data.set_var("gradp_x", gradphi_x)
            self.cc_data.set_var("gradp_y", gradphi_y)

        self.cc_data.fill_BC("x-velocity")
        self.cc_data.fill_BC("y-velocity")

        # the JAX package asks its data for a derived "velocity", which
        # the incompressible data lacks (a KeyError); the port advances
        # with the projected cell-centred velocities, and not in the
        # pre-evolution's throwaway step; section C.4 of ROADMAP.md
        # records it
        if self.particles is not None and not self.in_preevolve:
            self.particles.update_particles(
                self.dt, self.cc_data.get_var("x-velocity"),
                self.cc_data.get_var("y-velocity"))

        if not self.in_preevolve:
            self.cc_data.t += self.dt
            self.n += 1

    def dovis(self):
        """Runtime visualization: velocities, vorticity, div U."""
        from pyro2_tpu_torch.util import plot_tools

        myg = self.cc_data.grid
        u = self.cc_data.get_var("x-velocity")
        v = self.cc_data.get_var("y-velocity")

        plot_tools.plot_fields(
            self, [("x-velocity", u), ("y-velocity", v),
                   ("vorticity", plot_tools.vorticity(u, v, myg)),
                   ("div U", self._cc_divU(u, v, myg))])
