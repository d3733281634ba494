"""Method-of-lines compressible Simulation: Runge-Kutta stages over
flux-divergence + source increments.

The port of pyro2_tpu/solvers/compressible_rk/simulation.py.
`build_substep` is the plain stage increment k(U, t, dt) as tensor code;
`evolve` runs the RK stages through the MOL kernel's wrapper
(compressible_fv4.mol_kernel.MOLSubstep), which launches the CUDA kernel
for CUDA tensors and runs `build_substep` for CPU tensors.  The CTU step
of the base class is never built.
"""

import torch

import pyro2_tpu_torch.solvers.compressible_rk.fluxes as flx
from pyro2_tpu_torch.mesh import integration
from pyro2_tpu_torch.mesh.indexer import ai, embed
from pyro2_tpu_torch.solvers import compressible
from pyro2_tpu_torch.solvers.compressible import eos
from pyro2_tpu_torch.util import profile_pyro

__all__ = ["build_substep", "Simulation"]


def _floored(U, small_dens, ivars, myg):
    """A copy of U with the density floor on the global interior.  The
    default sentinel (-1e200) is out of f32 range: it is clamped to the
    dtype's finfo min, which keeps the floor a no-op."""
    floor = max(small_dens, torch.finfo(U.dtype).min)
    U = U.clone()
    sl = (ivars.idens, slice(myg.ilo, myg.ihi + 1),
          slice(myg.jlo, myg.jhi + 1))
    U[sl] = U[sl].clamp_min(floor)
    return U


def _sponge(k_v, U, ivars, rp, myg):
    """k += the implicit-sponge damping terms on the valid region."""
    kf = ai(compressible.get_sponge_factor(U, ivars, rp, myg), myg).v()
    Uv = ai(U, myg).v()
    k_v[ivars.ixmom] += -kf * Uv[ivars.ixmom]
    k_v[ivars.iymom] += -kf * Uv[ivars.iymom]
    k_v[ivars.iener] += -kf * (Uv[ivars.ixmom] ** 2 / Uv[ivars.idens] +
                               Uv[ivars.iymom] ** 2 / Uv[ivars.idens])
    return k_v


def build_substep(myg, rp, ivars, solid, tc, problem_source=None,
                  edges=(1, 1, 1, 1)):
    """The plain MOL stage increment substep(U, t, dt) -> k on a grid:
    k is zero on the ghosts, and U is not modified.  On a SphericalPolar
    grid the sources are spherical but the flux divergence stays the
    Cartesian one over dx and dy, as in the JAX package.  `edges` are the
    viscosity's domain-edge flags (fluxes.fluxes): a sharded block passes
    its own, where the JAX package's sharded rk passes none (section C.4
    of ROADMAP.md records the gap that leaves there)."""
    small_dens = rp.get_param("compressible.small_dens")
    do_sponge = rp.get_param("sponge.do_sponge")

    class _Data:
        grid = myg

    my_data = _Data()

    def substep(U, t, dt):
        U = _floored(U, small_dens, ivars, myg)

        S = compressible.get_external_sources(
            t, dt, U, ivars, rp, myg, problem_source=problem_source)

        F_x, F_y = flx.fluxes(U, my_data, rp, ivars, solid, tc, edges)
        Fx = ai(F_x, myg)
        Fy = ai(F_y, myg)
        k_v = ((Fx.v() - Fx.ip(1)) / myg.dx +
               (Fy.v() - Fy.jp(1)) / myg.dy +
               ai(S, myg).v())

        if do_sponge:
            k_v = _sponge(k_v, U, ivars, rp, myg)

        return embed(k_v, myg)

    return substep


class Simulation(compressible.Simulation):
    """The MOL compressible hydrodynamics solver."""

    MOL_KIND = "rk"

    # evolve is the MOL stages, not the CTU step (ROADMAP.md A.28)
    device_loop = False

    def _make_kernel_step(self):
        """The stage increment k(U, t, dt) through the MOL kernel's
        wrapper (no CTU step)."""
        from pyro2_tpu_torch.solvers.compressible_fv4.mol_kernel import \
            MOLSubstep
        return MOLSubstep(self, self.MOL_KIND)

    def _make_substep(self):
        """The plain stage-increment closure (the kernel's CPU twin)."""
        return build_substep(self.cc_data.grid, self.rp, self.ivars,
                             self.solid, self.tc,
                             problem_source=self.problem_source,
                             edges=self.domain_edges.flags())

    def substep(self, myd):
        """The RK increment for the stage state myd."""
        return self._step(myd.data, myd.t, self.dt)

    def _make_dt(self):
        """MOL CFL rule over every cell, ghosts included: the arithmetic of
        derives.derive_primitives' velocity and soundspeed, as the JAX
        package's method_compute_timestep reads them."""
        myg = self.cc_data.grid
        gamma = self.rp.get_param("eos.gamma")
        ivars = self.ivars

        def dt_fn(U):
            dens = U[ivars.idens]
            u = U[ivars.ixmom] / dens
            v = U[ivars.iymom] / dens
            e = (U[ivars.iener] - 0.5 * dens * (u * u + v * v)) / dens
            p = eos.pres(gamma, dens, e)
            cs = torch.sqrt(gamma * p / dens)
            xtmp = (u.abs() + cs) / myg.dx
            ytmp = (v.abs() + cs) / myg.dy
            return torch.min(1.0 / (xtmp + ytmp))

        return dt_fn

    def method_compute_timestep(self):
        """MOL CFL: dt = cfl * min(1 / ((|u|+cs)/dx + (|v|+cs)/dy))."""
        cfl = self.rp.get_param("driver.cfl")
        self.dt = cfl * profile_pyro.read(
            self._dt_fn(self.cc_data.data), "dt")

    def evolve(self):
        """Advance via the Butcher-tableau RK integrator: one stage
        increment (one kernel launch on CUDA) per stage."""
        myd = self.cc_data
        method = self.rp.get_param("compressible.temporal_method")
        rk = integration.RKIntegrator(myd.t, self.dt, method=method)
        rk.set_start(myd)

        for s in range(rk.nstages()):
            ytmp = rk.get_stage_start(s)
            ytmp.fill_BC_all()
            rk.store_increment(s, self.substep(ytmp))

        rk.compute_final_update()

        if self.particles is not None:
            self.particles.update_particles(
                self.dt, *self.particle_velocity(myd.data))

        myd.t += self.dt
        self.n += 1
