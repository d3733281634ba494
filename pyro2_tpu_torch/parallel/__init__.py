"""Parallel tiers of the port.  So far the ensemble tier only: a batch of
same-shape problems stepped together.  The rest of the JAX package's
parallel/ (the sharded mesh on torch.distributed) waits for a later slice
(ROADMAP.md, A.14)."""

from pyro2_tpu_torch.parallel.ensemble import ensemble_states, ensemble_step

__all__ = ["ensemble_states", "ensemble_step"]
