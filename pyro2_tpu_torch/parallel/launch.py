"""Run one program on every rank of a px x py mesh and collect the results.

The port's counterpart of calling a `shard_map` program from one process:
`run(fn, (px, py), *args)` starts px*py processes (the spawn start
method), joins them into one process group through a `FileStore` in a
temporary directory (no ports, no network), builds each rank's `Mesh`
(parallel.mesh_comm.make_mesh) and calls `fn(mesh, *args)` there.  The
ranks run on CUDA unless the caller passes device="cpu" (with no GPU and
no device given, `run` raises before it starts any rank): CUDA ranks talk
over NCCL, one card each; CPU ranks over gloo, and set torch to one thread
(the ranks share the host's cores).  Each rank's result
comes back with every tensor in it turned into a numpy array, in rank
order (rank r holds block (r // py, r % py)).

`fn` must be picklable: a function at the top level of an importable
module that does not import JAX.  The parent waits at most `timeout`
seconds; a rank that raises, dies or hangs makes `run` kill every rank and
raise, so a stuck collective fails its caller instead of stalling it.
"""

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pyro2_tpu_torch.defaults import resolve_device
from pyro2_tpu_torch.parallel.mesh_comm import make_mesh

__all__ = ["run", "to_host"]


def to_host(obj):
    """obj with every tensor in it (in lists, tuples and dicts) as a numpy
    array."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(rank, world, shape, store_path, device, timeout, fn, args,
               results):
    try:
        cuda = torch.device(device).type == "cuda"
        if not cuda:
            torch.set_num_threads(1)
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        mesh = make_mesh(shape=shape, device=device)
        results.put((rank, True, to_host(fn(mesh, *args))))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(fn, shape, *args, device=None, timeout=300.0):
    """[fn(mesh, *args) of rank 0, of rank 1, ...] on a `shape` mesh of
    ranks on `device` (CUDA by default: NCCL, one card per rank; "cpu":
    gloo)."""
    device = resolve_device(device).type
    px, py = shape
    world = px * py
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(
            target=_rank_main,
            args=(rank, world, shape, os.path.join(tmp, "store"), device,
                  timeout, fn, args, results), daemon=True)
            for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        out = {}
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{world - len(out)} of {world} ranks did not finish "
                        f"{getattr(fn, '__name__', fn)} within {timeout} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    # a rank that exited cleanly has its result in the pipe
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and "
                                           "no result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                out[rank] = payload
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
            results.close()
    return [out[r] for r in range(world)]
