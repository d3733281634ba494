"""Parallel tiers of the port.

* The ensemble tier: a batch of same-shape problems stepped together
  (`ensemble_step`, `ensemble_states`).
* The block mesh on torch.distributed (`mesh_comm`: one rank owns one
  block; gloo across CPU processes, NCCL on GPUs, no process group for a
  1 x 1 mesh), `launch.run` to start the ranks of a mesh from one process,
  per-block initialization (`blocks`), the block-partitioned multigrid
  (`ShardedMG`, `ShardedVarCoeffMG`, `ShardedGeneralMG`) and its first
  consumer, `ShardedDiffusion`.

The rest of the JAX package's parallel/ waits for later slices (ROADMAP.md,
A.14): sharded_incompressible first, then sharded.py (ShardedCompressible,
ShardedSWE) with sharded_hyperbolic, sharded_mol, sharded_lm_atm,
sharded_burgers_viscous, sharded_particles, accounting and overlap.
"""

from pyro2_tpu_torch.parallel.ensemble import ensemble_states, ensemble_step
from pyro2_tpu_torch.parallel.mesh_comm import (Mesh, factor_devices,
                                                halo_exchange, make_mesh)
from pyro2_tpu_torch.parallel.sharded_diffusion import ShardedDiffusion
from pyro2_tpu_torch.parallel.sharded_mg import (ShardedGeneralMG,
                                                 ShardedMG,
                                                 ShardedVarCoeffMG,
                                                 make_sharded_mg)

__all__ = ["Mesh", "ShardedDiffusion", "ShardedGeneralMG", "ShardedMG",
           "ShardedVarCoeffMG", "ensemble_states", "ensemble_step",
           "factor_devices", "halo_exchange", "make_mesh", "make_sharded_mg"]
