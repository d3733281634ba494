"""WENO method-of-lines advection (port of
pyro2_tpu.solvers.advection_weno).  No Pallas kernel: the plain stage
increment runs on CUDA as on the CPU."""

from pyro2_tpu_torch.solvers.advection_weno.simulation import Simulation
