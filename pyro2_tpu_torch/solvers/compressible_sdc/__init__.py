"""4th-order compressible solver with SDC time integration (port of
pyro2_tpu.solvers.compressible_sdc)."""

from pyro2_tpu_torch.solvers.compressible_sdc.simulation import Simulation
