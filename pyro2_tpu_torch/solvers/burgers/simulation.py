"""Inviscid Burgers Simulation.

The port of pyro2_tpu/solvers/burgers/simulation.py, here the base class of
the incompressible solver.  Velocity self-advection: limited slopes -> hat
interface states -> transverse Riemann corrections -> F = u^2/2 fluxes ->
conservative update, as plain tensor code.
"""

import torch

from pyro2_tpu_torch.mesh import reconstruction
from pyro2_tpu_torch.mesh.indexer import ai, fill_ghost
from pyro2_tpu_torch.simulation_null import (NullSimulation, bc_setup,
                                             grid_setup)
from pyro2_tpu_torch.solvers.burgers import burgers_interface


class Simulation(NullSimulation):

    def initialize(self):
        """Grid (ng=4), x/y-velocity variables, ICs, the step."""
        my_grid = grid_setup(self.rp, ng=4)
        my_data = self.data_class(my_grid)

        bc = bc_setup(self.rp)[0]
        my_data.register_var("x-velocity", bc)
        my_data.register_var("y-velocity", bc)
        my_data.create()
        self.cc_data = my_data
        self.init_particles(bc)

        self.problem_func(self.cc_data, self.rp)
        self._step = self._make_step()

    def _make_step(self, fill_ghosts=True):
        """step(u, v, dt) -> (u, v): one Burgers update; the inputs are
        not written.  fill_ghosts=False skips the entry ghost fills: the
        sharded step exchanges halos itself
        (parallel/sharded_hyperbolic.py)."""
        g = self.cc_data.grid
        bc_u = self.cc_data.BCs["x-velocity"]
        bc_v = self.cc_data.BCs["y-velocity"]
        limiter = self.rp.get_param("advection.limiter")

        def step(u, v, dt):
            if fill_ghosts:
                u = fill_ghost(u.clone(), g, bc_u)
                v = fill_ghost(v.clone(), g, bc_v)

            ldelta_ux = reconstruction.limit(u, g, 1, limiter)
            ldelta_uy = reconstruction.limit(u, g, 2, limiter)
            ldelta_vx = reconstruction.limit(v, g, 1, limiter)
            ldelta_vy = reconstruction.limit(v, g, 2, limiter)

            states = burgers_interface.get_interface_states(
                g, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy)
            states = burgers_interface.apply_transverse_corrections(
                g, dt, *states)
            fu_x, fu_y, fv_x, fv_y = \
                burgers_interface.construct_unsplit_fluxes(g, *states)

            dtdx = dt / g.dx
            dtdy = dt / g.dy
            uv = ai(u, g)
            vv = ai(v, g)
            fux = ai(fu_x, g)
            fuy = ai(fu_y, g)
            fvx = ai(fv_x, g)
            fvy = ai(fv_y, g)

            sl = (slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
            u_new = u.clone()
            v_new = v.clone()
            u_new[sl] = uv.v() + dtdx * (fux.v() - fux.ip(1)) + \
                dtdy * (fuy.v() - fuy.jp(1))
            v_new[sl] = vv.v() + dtdx * (fvx.v() - fvx.ip(1)) + \
                dtdy * (fvy.v() - fvy.jp(1))
            return u_new, v_new

        return step

    def method_compute_timestep(self):
        """CFL: dt = cfl * min(dx/max|u|, dy/max|v|)."""
        cfl = self.rp.get_param("driver.cfl")
        u = self.cc_data.get_var("x-velocity")
        v = self.cc_data.get_var("y-velocity")

        umax, vmax = torch.stack([u.abs().max(), v.abs().max()]).tolist()
        xtmp = self.cc_data.grid.dx / max(umax, self.SMALL)
        ytmp = self.cc_data.grid.dy / max(vmax, self.SMALL)
        self.dt = cfl * min(xtmp, ytmp)

    def evolve(self):
        """Advance the Burgers system through one timestep."""
        u = self.cc_data.get_var("x-velocity")
        v = self.cc_data.get_var("y-velocity")

        u_new, v_new = self._step(u, v, self.dt)
        self.cc_data.set_var("x-velocity", u_new)
        self.cc_data.set_var("y-velocity", v_new)

        if self.particles is not None:
            self.particles.update_particles(self.dt, u_new, v_new)

        self.cc_data.t += self.dt
        self.n += 1

    def dovis(self):
        from pyro2_tpu_torch.util import plot_tools
        plot_tools.plot_fields(
            self,
            [("x-velocity", self.cc_data.get_var("x-velocity")),
             ("y-velocity", self.cc_data.get_var("y-velocity"))])
