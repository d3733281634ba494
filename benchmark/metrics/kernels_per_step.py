"""kernels_per_step: device kernels a step in the traced window (copies
and fills of memory are no kernels), from the profiler."""

from harness.tracing import NOT_KERNEL


def read(ctx):
    t = ctx.trace
    if t.steps == 0:
        return None
    return sum(1 for n, _, _ in t.ops if not NOT_KERNEL.search(n)) / t.steps
