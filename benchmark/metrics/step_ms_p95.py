"""step_ms_p95: the 95th percentile of the wall time of every step of the
window (host clock).  A step's time is the interval between consecutive
returns of Pyro.single_step; the first starts at the window's start and
the last ends at its final synchronize.  Each step synchronizes at least
once (a dt read, or a multigrid cycle's norm read), so the intervals are
the steps' own.  None on the on-device loop, which shows no single step."""

import numpy as np


def read(ctx):
    d = ctx.window.durations
    if not d:
        return None
    return 1e3 * float(np.percentile(d, 95))
