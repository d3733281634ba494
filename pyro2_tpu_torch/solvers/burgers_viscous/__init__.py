"""Viscous Burgers: CTU advection plus a Crank-Nicolson diffusion solve
per velocity component on the constant multigrid (port of
pyro2_tpu.solvers.burgers_viscous)."""

from pyro2_tpu_torch.solvers.burgers_viscous.simulation import Simulation
