"""Shallow water equations CTU solver (port of pyro2_tpu.solvers.swe)."""

from pyro2_tpu_torch.solvers.swe.simulation import (Simulation, Variables,
                                                    cons_to_prim,
                                                    prim_to_cons)
