"""4th-order finite-volume advection (port of
pyro2_tpu.solvers.advection_fv4).  No Pallas kernel: the plain stage
increment runs on CUDA as on the CPU."""

from pyro2_tpu_torch.solvers.advection_fv4.simulation import Simulation
