"""Strang-split reacting compressible flow scaffold (port of
pyro2_tpu.solvers.compressible_react)."""

from pyro2_tpu_torch.solvers.compressible_react.simulation import Simulation
