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
  (`sharded_incompressible.py`), `ShardedBurgersViscous`
  (`sharded_burgers_viscous.py`) and `ShardedLMAtm`
  (`sharded_lm_atm.py`: a coefficient hierarchy installed a projection).
* The overlapped compressible and swe step (`build_overlapped_step`,
  `overlap=True`), and the communication accounting: `collective_stats`
  (the collectives one run of a program makes) and `halo_stats` (a step's
  halo bytes and overlap window, from the block geometry).

Every module of the JAX package's parallel/ has its counterpart here.
"""

from pyro2_tpu_torch.parallel.accounting import collective_stats
from pyro2_tpu_torch.parallel.ensemble import ensemble_states, ensemble_step
from pyro2_tpu_torch.parallel.mesh_comm import (Mesh, factor_devices,
                                                halo_exchange, make_mesh)
from pyro2_tpu_torch.parallel.overlap import build_overlapped_step, halo_stats
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
from pyro2_tpu_torch.parallel.sharded_lm_atm import ShardedLMAtm
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
           "ShardedLMAtm", "ShardedMG", "ShardedSWE", "ShardedSim",
           "ShardedVarCoeffMG", "build_overlapped_step", "collective_stats",
           "ensemble_states", "ensemble_step", "factor_devices",
           "halo_exchange", "halo_stats", "make_mesh",
           "make_sharded_compressible_step", "make_sharded_mg",
           "make_sharded_particle_advance"]
