"""Advection with a spatially varying velocity field (port of
pyro2_tpu.solvers.advection_nonuniform).  No Pallas kernel: the plain
tensor step runs on CUDA as on the CPU."""

from pyro2_tpu_torch.solvers.advection_nonuniform.simulation import \
    Simulation
