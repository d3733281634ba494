"""4th-order (McCorquodale & Colella) compressible solver (port of
pyro2_tpu.solvers.compressible_fv4)."""

from pyro2_tpu_torch.solvers.compressible_fv4.simulation import Simulation
