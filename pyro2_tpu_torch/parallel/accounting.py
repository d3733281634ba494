"""Collective-traffic accounting of the sharded programs.

The port of pyro2_tpu/parallel/accounting.py.  There the jaxpr of a traced
`shard_map` program is walked; here the program runs once, eagerly, with
`mesh_comm.record_collectives()` open, and every collective a `Mesh` makes
is tallied under the JAX primitive it stands for (ppermute, all_gather,
psum, pmin, pmax) with its per-rank payload bytes: the operands' bytes, as
the JAX walk counts them from the operand avals.

Three differences from the JAX tally:

* the program runs, so a loop whose trip count depends on the data (the
  multigrid solve loop, `ShardedMG.solve_local`) is counted for every
  trip it takes, where JAX counts a `while` body once.  `dynamic_trip` is
  True when a collective ran inside such a loop, as in JAX;
* an axis of one block does no communication and counts nothing, where
  the jaxpr keeps a reduction over it;
* the stacked halo fill (`mesh_comm.halo_exchange_stack`) sends one
  message a side for the whole (nvar, qx, qy) stack: 2 ppermutes per split
  axis, where JAX sends 2 nvar.  The bytes are the same.

Collective: every rank must call it, as every rank runs the program.
"""

from pyro2_tpu_torch.parallel.mesh_comm import record_collectives

__all__ = ["collective_stats"]


def collective_stats(fn, *args):
    """Run fn(*args) once and tally its collectives.

    Returns {"ppermute": {"count": n, "bytes": b}, ..., "total_bytes": B,
    "dynamic_trip": bool}: the bytes are this rank's payloads; a primitive
    that never ran has no entry."""
    with record_collectives() as rec:
        fn(*args)
    stats = {k: dict(v) for k, v in rec.stats.items()}
    stats["total_bytes"] = sum(v["bytes"] for v in rec.stats.values())
    stats["dynamic_trip"] = rec.dynamic
    return stats
