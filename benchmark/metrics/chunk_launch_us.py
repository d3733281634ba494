"""chunk_launch_us: the on-device loop's host microseconds a chunk, the
copy of the carry into the graph's buffers and the graph's replay launch:
the mean length of the `chunk` spans inside the traced window (the
program's spans, pyro2_tpu_torch/util/profile_pyro.py).  None where the
program recorded no chunk span there."""

from harness import program_spans


def read(ctx):
    chunks = [s.t1_ns - s.t0_ns
              for s in program_spans.in_window(ctx.trace)
              if s.name == "chunk"]
    if not chunks:
        return None
    return 1e-3 * sum(chunks) / len(chunks)
