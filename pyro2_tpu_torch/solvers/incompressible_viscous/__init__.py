"""Viscous incompressible flow: the projection method with a
Crank-Nicolson velocity update on the constant multigrid (port of
pyro2_tpu.solvers.incompressible_viscous)."""

from pyro2_tpu_torch.solvers.incompressible_viscous.simulation import \
    Simulation
