"""ctu_roofline_pct: the CTU step kernel's share of its roofline.  The
least time of one step (the frozen `work.ctu.work`: each state read once
and written once, the operations counted from ctu_step.cu; the larger of
bytes over bandwidth and operations over the dtype's peak) times the
k_ctu launches the profiler saw, over their summed device time.  None
where no k_ctu ran."""

from work import ctu, roofline


def read(ctx):
    t = ctx.trace
    launches, seconds = t.kernel("k_ctu")
    if launches == 0:
        return None
    nx, ny = t.grid
    sources = t.params.get("compressible.grav", 0.0) != 0.0
    nbytes, flops = ctu.work(nx, ny, t.nvar, t.dtype, with_sources=sources)
    return roofline.share_pct(
        launches * roofline.bound_s(nbytes, flops, t.dtype), seconds)
