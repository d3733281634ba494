"""Low-Mach-number atmospheric solver (port of pyro2_tpu.solvers.lm_atm)."""

from pyro2_tpu_torch.solvers.lm_atm.simulation import Simulation
