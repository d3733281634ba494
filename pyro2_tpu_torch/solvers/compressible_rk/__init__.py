"""Method-of-lines compressible solver (port of
pyro2_tpu.solvers.compressible_rk)."""

from pyro2_tpu_torch.solvers.compressible_rk.simulation import Simulation
