"""host_syncs_per_step: the program's blocking device-to-host reads a host
step: its `read:*` spans under the `step` spans that lie inside the traced
window, over those steps (the program's spans,
pyro2_tpu_torch/util/profile_pyro.py).  None where the program recorded no
step span there."""

from harness import program_spans


def read(ctx):
    steps = program_spans.under(program_spans.in_window(ctx.trace), "step",
                                "read:")
    if not steps:
        return None
    return sum(len(reads) for _, reads in steps) / len(steps)
