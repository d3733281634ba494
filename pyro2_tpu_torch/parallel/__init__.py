"""Parallel tiers of the port.

* The ensemble tier: a batch of same-shape problems stepped together
  (`ensemble_step`, `ensemble_states`).
* The block mesh on torch.distributed (`mesh_comm`: one rank owns one
  block; gloo across CPU processes, NCCL on GPUs, no process group for a
  1 x 1 mesh), `launch.run` to start the ranks of a mesh from one process,
  per-block initialization (`blocks`), the block-partitioned multigrid
  (`ShardedMG`, `ShardedVarCoeffMG`, `ShardedGeneralMG`) and its first
  consumer, `ShardedDiffusion`.
* The sharded hyperbolic tier: `ShardedCompressible` and `ShardedSWE`
  (`sharded.py`, the CTU and swe kernels as block steps),
  `ShardedAdvection` and `ShardedBurgers` (`sharded_hyperbolic.py`), and
  the replicated tracer particles (`make_sharded_particle_advance`).
* The sharded method-of-lines tier (`sharded_mol.py`):
  `ShardedCompressibleRK`, `ShardedCompressibleFV4` and
  `ShardedCompressibleSDC`, the rk and fv4 kernels as stage increments.
* The solvers with inline sharded multigrid solves:
  `ShardedIncompressible` and `ShardedIncompressibleViscous`
  (`sharded_incompressible.py`) and `ShardedBurgersViscous`
  (`sharded_burgers_viscous.py`).

The rest of the JAX package's parallel/ waits for later slices (ROADMAP.md,
A.14), in this order: sharded_lm_atm, accounting and overlap.
"""

from pyro2_tpu_torch.parallel.ensemble import ensemble_states, ensemble_step
from pyro2_tpu_torch.parallel.mesh_comm import (Mesh, factor_devices,
                                                halo_exchange, make_mesh)
from pyro2_tpu_torch.parallel.sharded import (ShardedCompressible,
                                              ShardedSim, ShardedSWE,
                                              make_sharded_compressible_step)
from pyro2_tpu_torch.parallel.sharded_burgers_viscous import \
    ShardedBurgersViscous
from pyro2_tpu_torch.parallel.sharded_diffusion import ShardedDiffusion
from pyro2_tpu_torch.parallel.sharded_hyperbolic import (ShardedAdvection,
                                                         ShardedBurgers)
from pyro2_tpu_torch.parallel.sharded_incompressible import (
    ShardedIncompressible, ShardedIncompressibleViscous)
from pyro2_tpu_torch.parallel.sharded_mg import (ShardedGeneralMG,
                                                 ShardedMG,
                                                 ShardedVarCoeffMG,
                                                 make_sharded_mg)
from pyro2_tpu_torch.parallel.sharded_mol import (ShardedCompressibleFV4,
                                                  ShardedCompressibleRK,
                                                  ShardedCompressibleSDC)
from pyro2_tpu_torch.parallel.sharded_particles import \
    make_sharded_particle_advance

__all__ = ["Mesh", "ShardedAdvection", "ShardedBurgers",
           "ShardedBurgersViscous", "ShardedCompressible",
           "ShardedCompressibleFV4", "ShardedCompressibleRK",
           "ShardedCompressibleSDC", "ShardedDiffusion", "ShardedGeneralMG",
           "ShardedIncompressible", "ShardedIncompressibleViscous",
           "ShardedMG", "ShardedSWE", "ShardedSim", "ShardedVarCoeffMG",
           "ensemble_states", "ensemble_step", "factor_devices",
           "halo_exchange", "make_mesh", "make_sharded_compressible_step",
           "make_sharded_mg", "make_sharded_particle_advance"]
