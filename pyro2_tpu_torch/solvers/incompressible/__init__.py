"""Incompressible flow via an approximate projection method (port of
pyro2_tpu.solvers.incompressible)."""

from pyro2_tpu_torch.solvers.incompressible.simulation import Simulation
