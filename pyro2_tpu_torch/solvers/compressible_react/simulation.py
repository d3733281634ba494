"""Reacting compressible Simulation.

The port of pyro2_tpu/solvers/compressible_react/simulation.py: the CTU
compressible solver with the advected species "fuel" and "ash" (nvar 6),
in a Strang-split scaffold whose burn and diffuse are stubs, as in the
JAX package.  `evolve` steps through the CUDA CTU kernel's wrapper, which
takes passive scalars; `dovis` draws the fuel fraction beside the base
solver's fields.
"""

import torch

from pyro2_tpu_torch.solvers import compressible
from pyro2_tpu_torch.solvers.compressible import eos

__all__ = ["Simulation"]


class Simulation(compressible.Simulation):
    """The compressible solver with fuel and ash species."""

    # evolve wraps the step in burn and diffuse (ROADMAP.md A.28)
    device_loop = False

    def initialize(self, *, extra_vars=None, ng=4):
        """Same as compressible, plus the fuel and ash species."""
        super().initialize(extra_vars=["fuel", "ash"] + (extra_vars or []),
                           ng=ng)

    def dovis(self):
        """Runtime visualization incl. the fuel fraction."""
        from pyro2_tpu_torch.util import plot_tools

        ivars = compressible.Variables(self.cc_data)
        gamma = self.cc_data.get_aux("gamma")
        myg = self.cc_data.grid
        q = compressible.cons_to_prim(self.cc_data.data, gamma, ivars, myg)

        rho = q[ivars.irho]
        u = q[ivars.iu]
        v = q[ivars.iv]
        p = q[ivars.ip]
        e = eos.rhoe(gamma, p) / rho
        magvel = torch.sqrt(u ** 2 + v ** 2)

        plot_tools.plot_fields(
            self, [(r"$\rho$", rho), ("U", magvel), ("p", p), ("e", e),
                   (r"$X_\mathrm{fuel}$", q[ivars.ix])])

    def burn(self, dt):
        """React fuel to ash (a stub, as in the JAX package)."""

    def diffuse(self, dt):
        """Diffuse for dt (a stub, as in the JAX package)."""

    def evolve(self):
        """Strang splitting: burn and diffuse halves around the hydro
        step."""
        self.burn(self.dt / 2)
        self.diffuse(self.dt / 2)

        # half a step before the hydro step and half after it, around the
        # whole step the base evolve moves them: 2 dt a step, as in the
        # JAX package; section C.4 of ROADMAP.md records it
        if self.particles is not None:
            self.particles.update_particles(
                self.dt / 2, *self.particle_velocity(self.cc_data.data))

        super().evolve()

        if self.particles is not None:
            self.particles.update_particles(
                self.dt / 2, *self.particle_velocity(self.cc_data.data))

        self.diffuse(self.dt / 2)
        self.burn(self.dt / 2)
