"""Implicit (Crank-Nicolson) diffusion via multigrid (port of
pyro2_tpu.solvers.diffusion)."""

from pyro2_tpu_torch.solvers.diffusion.simulation import Simulation
