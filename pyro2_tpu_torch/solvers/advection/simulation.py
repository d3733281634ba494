"""Linear advection Simulation.

The port of pyro2_tpu/solvers/advection/simulation.py: ghost fill -> CTU
fluxes -> conservative update of the single "density" variable, as plain
tensor code on the simulation's device.  The update writes the interior
of a clone of the density.  `_contract_step` and `_dt_fn` are the
stack-shaped step and the raw pre-CFL dt the on-device loop
(driver_loop.py) runs.
"""

import torch

from pyro2_tpu_torch.mesh.indexer import ai, fill_ghost
from pyro2_tpu_torch.simulation_null import (NullSimulation, bc_setup,
                                             grid_setup)
from pyro2_tpu_torch.solvers.advection import advective_fluxes as flx


def conservative_update(a, fx, fy, g, dt):
    """A clone of `a` whose interior holds a + dt div(F) (the fluxes on
    the zones' left edges)."""
    fxv = ai(fx, g)
    fyv = ai(fy, g)
    new = a.clone()
    new[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = (
        ai(a, g).v() + dt / g.dx * (fxv.v() - fxv.ip(1))
        + dt / g.dy * (fyv.v() - fyv.jp(1)))
    return new


class Simulation(NullSimulation):

    # evolve is fill -> step -> particle advance, the on-device loop's body
    device_loop = True

    def initialize(self):
        """Grid (ng=4), the single "density" variable, ICs, the step."""
        my_grid = grid_setup(self.rp, ng=4)

        my_data = self.data_class(my_grid)
        bc = bc_setup(self.rp)[0]
        my_data.register_var("density", bc)
        my_data.create()
        self.cc_data = my_data
        self.init_particles(bc)

        self.problem_func(self.cc_data, self.rp)
        self._step = self._build_step()

    def _contract_step(self, U, t, dt):
        """The step on the (1, qx, qy) state stack: row 0 advanced by dt
        (a float or a 0-d tensor)."""
        new = U.clone()
        new[0] = self._step(U[0], dt)
        return new

    def _raw_dt(self):
        """The pre-CFL dt, min(dx/|u|, dy/|v|), a host float."""
        g = self.cc_data.grid
        u = self.rp.get_param("advection.u")
        v = self.rp.get_param("advection.v")
        return min(g.dx / max(abs(u), self.SMALL),
                   g.dy / max(abs(v), self.SMALL))

    def _dt_fn(self, U):
        """The raw pre-CFL dt as a 0-d tensor of U's dtype on its device
        (made by a fill, no host copy)."""
        return torch.full((), self._raw_dt(), dtype=U.dtype,
                          device=U.device)

    def particle_velocity(self, U=None):
        """(u, v): the advection velocity as two (qx, qy) planes in the
        state's dtype on its device, which the particles advance with
        (made once; nothing writes them)."""
        if "_velocity_planes" not in self.__dict__:
            g = self.cc_data.grid
            like = {"dtype": self.cc_data.dtype,
                    "device": self.cc_data.device}
            self._velocity_planes = tuple(
                torch.full((g.qx, g.qy), self.rp.get_param(f"advection.{c}"),
                           **like) for c in "uv")
        return self._velocity_planes

    def _build_step(self, fill_ghosts=True):
        """step(a, dt) -> the density after one CTU update; `a` is not
        written.  fill_ghosts=False skips the entry ghost fill: the
        sharded step exchanges halos itself
        (parallel/sharded_hyperbolic.py)."""
        g = self.cc_data.grid
        bc = self.cc_data.BCs["density"]
        u = self.rp.get_param("advection.u")
        v = self.rp.get_param("advection.v")
        limiter = self.rp.get_param("advection.limiter")

        def step(a, dt):
            if fill_ghosts:
                a = fill_ghost(a.clone(), g, bc)
            flux_x, flux_y = flx.unsplit_fluxes(a, g, u, v, limiter, dt)
            return conservative_update(a, flux_x, flux_y, g, dt)

        return step

    def method_compute_timestep(self):
        """CFL constraint: dt = cfl * min(dx/|u|, dy/|v|), on the host."""
        self.dt = self.rp.get_param("driver.cfl") * self._raw_dt()

    def evolve(self):
        """Advance density through one timestep."""
        dens = self.cc_data.get_var("density")
        self.cc_data.set_var("density", self._step(dens, self.dt))

        if self.particles is not None:
            self.particles.update_particles(self.dt,
                                            *self.particle_velocity())

        self.cc_data.t += self.dt
        self.n += 1

    def dovis(self):
        from pyro2_tpu_torch.util import plot_tools
        plot_tools.plot_fields(
            self, [("density", self.cc_data.get_var("density"))],
            title="density")
