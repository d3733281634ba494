"""setup_s: seconds from the start of the process to the first timed
step: imports, the CUDA context, the kernels' build or load, the problem's
set-up and the warm-up (host clock)."""


def read(ctx):
    return ctx.window.setup_s
