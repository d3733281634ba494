"""2nd-order unsplit CTU linear advection (port of
pyro2_tpu.solvers.advection), also the base of the advection_rk, fv4 and
weno solvers.  It has no Pallas kernel, so its plain tensor step runs on
CUDA as on the CPU."""

from pyro2_tpu_torch.solvers.advection.simulation import Simulation
