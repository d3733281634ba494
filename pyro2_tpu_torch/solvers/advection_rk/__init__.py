"""Method-of-lines linear advection with RK time integration (port of
pyro2_tpu.solvers.advection_rk), the base of the fv4 and weno solvers.
No Pallas kernel: the plain stage increment runs on CUDA as on the CPU."""

from pyro2_tpu_torch.solvers.advection_rk.simulation import Simulation
