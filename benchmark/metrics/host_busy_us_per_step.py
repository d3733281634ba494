"""host_busy_us_per_step: the host's own microseconds a host step: the
mean over the `step` spans inside the traced window of each one's length
less the union of its `read:*` descendants, the time it waited on the
device (the program's spans, pyro2_tpu_torch/util/profile_pyro.py).  None
where the program recorded no step span there."""

from harness import program_spans
from harness.tracing import union_s


def read(ctx):
    steps = program_spans.under(program_spans.in_window(ctx.trace), "step",
                                "read:")
    if not steps:
        return None
    busy = [(s.t1_ns - s.t0_ns) * 1e-9 -
            union_s([(r.t0_ns, r.t1_ns) for r in reads], s.t0_ns, s.t1_ns)
            for s, reads in steps]
    return 1e6 * sum(busy) / len(busy)
