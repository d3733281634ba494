"""mg_roofline_pct: the multigrid kernels' share of their roofline.  The
least time of one V-cycle of the finest level (the frozen
`work.mg.cycle_launches` and `work.mg.work`: a down and an up a peeled
level, the core; each call's larger of bytes over bandwidth and operations
over the dtype's peak) times the cycles the port counted
(multigrid/MG.py `stats`), over the summed device time of the k_down,
k_up and k_core launches the profiler saw.  None where no cycle ran."""

from work import mg, roofline


def read(ctx):
    t = ctx.trace
    cycles = t.counts.get("cycles", 0)
    seconds = sum(t.kernel(k)[1] for k in ("k_down", "k_up", "k_core"))
    if cycles == 0 or seconds == 0.0:
        return None
    bound = sum(roofline.bound_s(*mg.work(entry, n, mg.NSMOOTH, t.dtype,
                                          with_guess=guess, want_r=want_r),
                                 t.dtype)
                for entry, n, guess, want_r in
                mg.cycle_launches(t.grid[0], t.dtype))
    return roofline.share_pct(cycles * bound, seconds)
