"""zone_updates_per_s: interior zones times the steps completed in the
window, over the window's wall seconds up to its final synchronize (host
clock)."""


def read(ctx):
    w = ctx.window
    return w.zones * w.steps / (w.t_end - w.t0)
