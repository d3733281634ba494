"""mg_cycles_per_solve: V-cycles over multigrid solves in the traced
window, from the port's own counter (multigrid/MG.py `stats`).  None
where no solve ran."""


def read(ctx):
    c = ctx.trace.counts
    if c.get("solves", 0) == 0:
        return None
    return c["cycles"] / c["solves"]
