"""Reacting compressible Simulation.

The port of pyro2_tpu/solvers/compressible_react/simulation.py: the CTU
compressible solver with the advected species "fuel" and "ash" (nvar 6),
in a Strang-split scaffold whose burn and diffuse are stubs, as in the
JAX package.  `evolve` steps through the CUDA CTU kernel's wrapper, which
takes passive scalars; particles raise naming ROADMAP.md A.17 and `dovis`
naming A.13, as in the base solver.
"""

from pyro2_tpu_torch.solvers import compressible

__all__ = ["Simulation"]


class Simulation(compressible.Simulation):
    """The compressible solver with fuel and ash species."""

    def initialize(self, *, extra_vars=None, ng=4):
        """Same as compressible, plus the fuel and ash species."""
        super().initialize(extra_vars=["fuel", "ash"] + (extra_vars or []),
                           ng=ng)

    def burn(self, dt):
        """React fuel to ash (a stub, as in the JAX package)."""

    def diffuse(self, dt):
        """Diffuse for dt (a stub, as in the JAX package)."""

    def evolve(self):
        """Strang splitting: burn and diffuse halves around the hydro
        step."""
        self.burn(self.dt / 2)
        self.diffuse(self.dt / 2)

        super().evolve()

        self.diffuse(self.dt / 2)
        self.burn(self.dt / 2)
