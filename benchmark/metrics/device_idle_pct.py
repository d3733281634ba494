"""device_idle_pct: 100 (1 - the union of the device operations' intervals
over the traced window's length), from the profiler."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
