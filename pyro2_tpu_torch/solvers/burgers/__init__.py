"""Inviscid Burgers solver: CTU velocity self-advection (port of
pyro2_tpu.solvers.burgers), also the base of the incompressible and
viscous Burgers solvers.  It has no Pallas kernel, so its plain tensor
step runs on CUDA as on the CPU."""

from pyro2_tpu_torch.solvers.burgers.simulation import Simulation
