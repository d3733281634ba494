"""Compressible Euler CTU solver (port of pyro2_tpu.solvers.compressible)."""

from pyro2_tpu_torch.solvers.compressible.simulation import (
    Simulation, Variables, cons_to_prim, get_external_sources,
    get_sponge_factor, prim_to_cons)
