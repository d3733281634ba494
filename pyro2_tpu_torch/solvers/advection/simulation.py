"""Linear advection Simulation.

The port of pyro2_tpu/solvers/advection/simulation.py: ghost fill -> CTU
fluxes -> conservative update of the single "density" variable, as plain
tensor code on the simulation's device.  The update writes the interior
of a clone of the density.
"""

from pyro2_tpu_torch.mesh.indexer import ai, fill_ghost
from pyro2_tpu_torch.simulation_null import (NullSimulation, bc_setup,
                                             grid_setup)
from pyro2_tpu_torch.solvers.advection import advective_fluxes as flx


def refuse_particles(rp):
    """Particles are not ported: do_particles = 1 raises."""
    if rp.get_param("particles.do_particles") == 1:
        raise NotImplementedError(
            "particles wait for a later slice of the port (ROADMAP.md A.17)")


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

    def initialize(self):
        """Grid (ng=4), the single "density" variable, ICs, the step."""
        refuse_particles(self.rp)
        my_grid = grid_setup(self.rp, ng=4)

        my_data = self.data_class(my_grid)
        bc = bc_setup(self.rp)[0]
        my_data.register_var("density", bc)
        my_data.create()
        self.cc_data = my_data

        self.problem_func(self.cc_data, self.rp)
        self._step = self._build_step()

    def _build_step(self):
        """step(a, dt) -> the density after one CTU update; `a` is not
        written."""
        g = self.cc_data.grid
        bc = self.cc_data.BCs["density"]
        u = self.rp.get_param("advection.u")
        v = self.rp.get_param("advection.v")
        limiter = self.rp.get_param("advection.limiter")

        def step(a, dt):
            a = fill_ghost(a.clone(), g, bc)
            flux_x, flux_y = flx.unsplit_fluxes(a, g, u, v, limiter, dt)
            return conservative_update(a, flux_x, flux_y, g, dt)

        return step

    def method_compute_timestep(self):
        """CFL constraint: dt = cfl * min(dx/|u|, dy/|v|), on the host."""
        cfl = self.rp.get_param("driver.cfl")
        u = self.rp.get_param("advection.u")
        v = self.rp.get_param("advection.v")

        xtmp = self.cc_data.grid.dx / max(abs(u), self.SMALL)
        ytmp = self.cc_data.grid.dy / max(abs(v), self.SMALL)
        self.dt = cfl * min(xtmp, ytmp)

    def evolve(self):
        """Advance density through one timestep."""
        dens = self.cc_data.get_var("density")
        self.cc_data.set_var("density", self._step(dens, self.dt))

        self.cc_data.t += self.dt
        self.n += 1

    def dovis(self):
        raise NotImplementedError(
            "runtime visualization waits for a later slice of the port "
            "(ROADMAP.md A.13); run with vis.dovis=0")
