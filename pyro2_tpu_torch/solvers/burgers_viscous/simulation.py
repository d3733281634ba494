"""Viscous Burgers Simulation (the port of
pyro2_tpu/solvers/burgers_viscous/simulation.py): CTU advective fluxes
with diffusion-corrected interface states, then one Crank-Nicolson
multigrid solve per velocity component with the advective source.

The advective stages are plain tensor code on the state's device; the two
solves of a step run on the constant multigrid, whose V-cycles go through
the CUDA multigrid kernels on the GPU.
"""

import torch

from pyro2_tpu_torch.mesh import reconstruction
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.solvers.burgers import Simulation as burgers_sim
from pyro2_tpu_torch.solvers.burgers import burgers_interface
from pyro2_tpu_torch.solvers.burgers_viscous import interface


class Simulation(burgers_sim):

    def _make_step(self):
        # evolve below does the step, with its multigrid solves
        return None

    def evolve(self):
        """Advance the viscous Burgers system through one timestep."""
        myg = self.cc_data.grid
        u = self.cc_data.get_var("x-velocity")
        v = self.cc_data.get_var("y-velocity")

        limiter = self.rp.get_param("advection.limiter")
        eps = self.rp.get_param("diffusion.eps")

        ldelta_ux = reconstruction.limit(u, myg, 1, limiter)
        ldelta_uy = reconstruction.limit(u, myg, 2, limiter)
        ldelta_vx = reconstruction.limit(v, myg, 1, limiter)
        ldelta_vy = reconstruction.limit(v, myg, 2, limiter)

        states = burgers_interface.get_interface_states(
            myg, self.dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy)
        states = interface.apply_diffusion_corrections(
            myg, self.dt, eps, u, v, *states)
        states = burgers_interface.apply_transverse_corrections(
            myg, self.dt, *states)
        u_flux_x, u_flux_y, v_flux_x, v_flux_y = \
            burgers_interface.construct_unsplit_fluxes(myg, *states)

        # advective source terms for the diffusion solve
        ufx = ai(u_flux_x, myg)
        ufy = ai(u_flux_y, myg)
        vfx = ai(v_flux_x, myg)
        vfy = ai(v_flux_y, myg)
        sl = (slice(myg.ilo, myg.ihi + 1), slice(myg.jlo, myg.jhi + 1))
        A_u = torch.zeros_like(u)
        A_u[sl] = (ufx.ip(1) - ufx.v()) / myg.dx + \
            (ufy.jp(1) - ufy.v()) / myg.dy
        A_v = torch.zeros_like(v)
        A_v[sl] = (vfx.ip(1) - vfx.v()) / myg.dx + \
            (vfy.jp(1) - vfy.v()) / myg.dy

        self.cc_data.set_var(
            "x-velocity",
            interface.diffuse(self.cc_data, self.rp, self.dt,
                              "x-velocity", A_u))
        self.cc_data.set_var(
            "y-velocity",
            interface.diffuse(self.cc_data, self.rp, self.dt,
                              "y-velocity", A_v))

        if self.particles is not None:
            self.particles.update_particles(
                self.dt, self.cc_data.get_var("x-velocity"),
                self.cc_data.get_var("y-velocity"))

        self.cc_data.t += self.dt
        self.n += 1
