"""Method-of-lines advection Simulation (the port of
pyro2_tpu/solvers/advection_rk/simulation.py): RK stages through
mesh/integration.RKIntegrator over the flux-divergence increment.  The
CTU step of the base class is never built."""

import pyro2_tpu_torch.solvers.advection_rk.fluxes as flx
from pyro2_tpu_torch.mesh import integration
from pyro2_tpu_torch.mesh.indexer import ai, embed
from pyro2_tpu_torch.solvers import advection


class Simulation(advection.Simulation):

    # evolve is the RK stages, not the one-step update (ROADMAP.md A.28)
    device_loop = False

    def _build_step(self):
        return None

    # the flux routine (overridden by the fv4 and weno subclasses)
    @property
    def flux_fn(self):
        return flx.fluxes

    def substep(self, myd):
        """The RK increment -div(F) for the stage state myd, as a
        (1, qx, qy) stack that is zero on the ghosts."""
        g = myd.grid
        F_x, F_y = self.flux_fn(myd.get_var("density"), g, self.rp)
        fx = ai(F_x, g)
        fy = ai(F_y, g)
        k_v = (fx.v() - fx.ip(1)) / g.dx + (fy.v() - fy.jp(1)) / g.dy
        return embed(k_v, g)[None]

    def method_compute_timestep(self):
        """MOL CFL: dt = cfl / (|u|/dx + |v|/dy), on the host."""
        cfl = self.rp.get_param("driver.cfl")
        u = self.rp.get_param("advection.u")
        v = self.rp.get_param("advection.v")
        xtmp = max(abs(u), self.SMALL) / self.cc_data.grid.dx
        ytmp = max(abs(v), self.SMALL) / self.cc_data.grid.dy
        self.dt = cfl / (xtmp + ytmp)

    def evolve(self):
        """Advance via the Butcher-tableau RK integrator."""
        myd = self.cc_data
        method = self.rp.get_param("advection.temporal_method")
        rk = integration.RKIntegrator(myd.t, self.dt, method=method)
        rk.set_start(myd)

        for s in range(rk.nstages()):
            ytmp = rk.get_stage_start(s)
            ytmp.fill_BC_all()
            rk.store_increment(s, self.substep(ytmp))

        rk.compute_final_update()

        if self.particles is not None:
            self.particles.update_particles(self.dt,
                                            *self.particle_velocity())

        myd.t += self.dt
        self.n += 1
