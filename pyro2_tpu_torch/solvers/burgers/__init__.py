"""Inviscid Burgers solver (port of pyro2_tpu.solvers.burgers), the base of
the incompressible solver.  Pyro("burgers") and its problems wait for a
later slice (ROADMAP.md A.12)."""

from pyro2_tpu_torch.solvers.burgers.simulation import Simulation
