"""torch_op_us_per_step: device microseconds a step in operations that
are not the port's own CUDA kernels (csrc/*.cu, k_*): the ghost fill, the
CFL dt, the on-device loop's clone and selects, the multigrid norms and
right-hand side, and any copy or fill of memory (profiler)."""

from harness.tracing import OWN_KERNEL


def read(ctx):
    t = ctx.trace
    if t.steps == 0:
        return None
    ns = sum(e - s for n, s, e in t.ops if not OWN_KERNEL.search(n))
    return ns * 1e-3 / t.steps
