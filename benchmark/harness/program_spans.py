"""The program's own spans (pyro2_tpu_torch/util/profile_pyro.py: name,
id, parent, step, t0_ns, t1_ns on the profiler's clock) that lie wholly
inside a traced window, for the readers of the per-layer metrics that
come from them.  A program that records no spans gives none, and those
readers then read nothing."""

__all__ = ["in_window", "under"]


def in_window(trace):
    """The program's spans that lie wholly inside `trace.window`."""
    try:
        from pyro2_tpu_torch.util import profile_pyro
    except ImportError:
        return []
    recorded = getattr(profile_pyro, "spans", None)
    if recorded is None:
        return []
    lo, hi = trace.window
    return [s for s in recorded() if lo <= s.t0_ns and s.t1_ns <= hi]


def under(spans, root, prefix):
    """[(span, [its descendants whose name starts with prefix])] for each
    span named `root` among `spans`, in the order given."""
    by_id = {s.id: s for s in spans}
    roots = {s.id: (s, []) for s in spans if s.name == root}
    for s in spans:
        if not s.name.startswith(prefix):
            continue
        p = by_id.get(s.parent)
        while p is not None and p.id not in roots:
            p = by_id.get(p.parent)
        if p is not None:
            roots[p.id][1].append(s)
    return list(roots.values())
