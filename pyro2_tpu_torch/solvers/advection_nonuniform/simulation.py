"""Non-uniform-velocity advection Simulation (the port of
pyro2_tpu/solvers/advection_nonuniform/simulation.py).  The upwind shift
masks are computed on the device; the CFL reads max|u| and max|v| from
the device once a step, as the JAX package does."""

import torch

import pyro2_tpu_torch.solvers.advection_nonuniform.advective_fluxes as flx
from pyro2_tpu_torch.simulation_null import (NullSimulation, bc_setup,
                                             grid_setup)
from pyro2_tpu_torch.solvers.advection.simulation import \
    conservative_update


def _shift(velocity):
    """Upwind shift per cell: 0 where vel <= 0, -1 where vel > 0."""
    return torch.where(velocity > 0, -1.0, 0.0)


class Simulation(NullSimulation):

    def initialize(self):
        """Grid (ng=4); velocity, shift-mask, and density variables."""
        my_grid = grid_setup(self.rp, ng=4)
        bc, bc_xodd, bc_yodd = bc_setup(self.rp)

        my_data = self.data_class(my_grid)
        my_data.register_var("x-velocity", bc_xodd)
        my_data.register_var("y-velocity", bc_yodd)
        my_data.register_var("x-shift", bc_xodd)
        my_data.register_var("y-shift", bc_yodd)
        my_data.register_var("density", bc)
        my_data.create()
        self.cc_data = my_data
        self.init_particles(bc)

        self.problem_func(self.cc_data, self.rp)
        self.cc_data.set_var("x-shift",
                             _shift(self.cc_data.get_var("x-velocity")))
        self.cc_data.set_var("y-shift",
                             _shift(self.cc_data.get_var("y-velocity")))

        self._step = self._build_step()

    def _build_step(self):
        """step(a, u, v, shx, shy, dt) -> the density after one update;
        no input is written."""
        g = self.cc_data.grid
        rp = self.rp

        def step(a, u, v, shx, shy, dt):
            F_x, F_y = flx.unsplit_fluxes(a, u, v, shx, shy, g, rp, dt)
            return conservative_update(a, F_x, F_y, g, dt)

        return step

    def method_compute_timestep(self):
        """CFL from the max velocity magnitudes (one device read)."""
        cfl = self.rp.get_param("driver.cfl")
        u = self.cc_data.get_var("x-velocity")
        v = self.cc_data.get_var("y-velocity")
        umax, vmax = torch.stack([u.abs().max(), v.abs().max()]).tolist()
        xtmp = self.cc_data.grid.dx / umax
        ytmp = self.cc_data.grid.dy / vmax
        self.dt = cfl * min(xtmp, ytmp)

    def evolve(self):
        """Advance density through one timestep."""
        d = self.cc_data
        a_new = self._step(d.get_var("density"), d.get_var("x-velocity"),
                           d.get_var("y-velocity"), d.get_var("x-shift"),
                           d.get_var("y-shift"), self.dt)
        d.set_var("density", a_new)

        if self.particles is not None:
            self.particles.update_particles(self.dt,
                                            d.get_var("x-velocity"),
                                            d.get_var("y-velocity"))

        d.t += self.dt
        self.n += 1

    def dovis(self):
        from pyro2_tpu_torch.util import plot_tools
        plot_tools.plot_fields(
            self, [("density", self.cc_data.get_var("density"))],
            title="density")
