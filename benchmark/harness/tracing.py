"""The traced window: torch.profiler over the timed loop, reduced to what
the per-layer readers take.

The harness records its own spans from its own files: in the traced run
only, it wraps the simulation's `cc_data.fill_BC_all`, `compute_timestep`
and `evolve` (and, on the on-device loop, the chunk runner and its status
read) on the instance in `torch.profiler.record_function` ranges named
`bench:<call>`, so each idle gap of the device is labelled with the host
call that was running.  The profiler loses device records now and then;
a session that saw fewer launches of the port's kernels than the port's
own counters show is made once more, with a longer pad, and then fails.
"""

import re
import time

import torch

__all__ = ["OWN_KERNEL", "ProfilerShort", "Trace", "traced", "union_s"]

# the port's own CUDA kernels (csrc/*.cu), matched in the profiler's name
# whether it comes demangled ("void k_ctu<float, 4, ...>(...)") or not
# ("_Z5k_ctuIfLi4E...")
KERNELS = ("k_ctu", "k_swe", "k_rk", "k_fv4", "k_lm_mac", "k_lm_rho",
           "k_lm_states", "k_down", "k_up", "k_core", "k_deep", "k_correct",
           "k_sweep")


def _named(names):
    return re.compile(r"(?<![A-Za-z_])(%s)(?![a-z0-9_])" % "|".join(names))


OWN_KERNEL = _named(KERNELS)
# the kernels whose launches the port counts; each name's pattern
COUNTED = {k: _named([k]) for k in ("k_ctu", "k_down", "k_up", "k_core")}
# copies and fills of memory: device operations that are no kernels
NOT_KERNEL = re.compile(r"^(Memcpy|Memset)")
SPAN = "bench:"
PAD_S = (0.02, 0.5)


def short_name(name):
    """A device operation's name without its namespace noise and argument
    list, at most 100 characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.replace("at::native::", "").split("(")[0]
    return name[5:105] if name.startswith("void ") else name[:100]


class ProfilerShort(RuntimeError):
    """The profiler recorded fewer launches than the port counted."""


def union_s(intervals, lo, hi):
    """Seconds of [lo, hi] (ns) covered by the union of (start, end)
    intervals (ns)."""
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total * 1e-9


class Trace:
    """A traced window: `ops` [(name, start_ns, end_ns)] of the device
    operations inside it, `window` (start_ns, end_ns), `spans` the
    harness's host ranges, `steps` the steps run, `counts` the deltas of
    the port's counters, and the cell's `params`, `dtype`, `grid` and
    state shape `nvar`."""

    def __init__(self, ops, window, spans, steps, counts, cell, params,
                 nvar):
        self.ops, self.window, self.spans = ops, window, spans
        self.steps, self.counts = steps, counts
        self.params, self.dtype = params, cell.dtype
        self.grid = tuple(cell.traffic["grid"])
        self.nvar = nvar

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_s(self):
        return union_s([(s, e) for _, s, e in self.ops], *self.window)

    def kernel(self, name):
        """(launches, device seconds) of the kernel `name` (k_ctu, ...)."""
        pattern = COUNTED.get(name) or _named([name])
        hits = [(s, e) for n, s, e in self.ops if pattern.search(n)]
        return len(hits), sum(e - s for s, e in hits) * 1e-9

    def seen(self):
        """Launches of each counted kernel in the trace."""
        return {k: self.kernel(k)[0] for k in COUNTED}

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle gaps
        summed by the harness span the host was in at their middle."""
        by_op = {}
        for n, s, e in self.ops:
            key = short_name(n)
            by_op[key] = by_op.get(key, 0.0) + (e - s) * 1e-9
        gaps = {}
        end = self.window[0]
        spans = sorted(self.spans, key=lambda x: x[1])
        for _, s, e in sorted(self.ops, key=lambda x: x[1]) + \
                [("", self.window[1], self.window[1])]:
            if s > end:
                mid = 0.5 * (s + end)
                label = "outside the harness's spans"
                inner = [x for x in spans if x[1] <= mid <= x[2]]
                if inner:
                    label = "host in " + max(inner, key=lambda x: x[1])[0]
                gaps[label] = gaps.get(label, 0.0) + (s - end) * 1e-9
            end = max(end, e)
        rank = sorted(by_op.items(), key=lambda x: -x[1])[:top]
        idle = sorted(gaps.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[k, v] for k, v in rank],
                "idle_gaps": [[k, v] for k, v in idle]}


def _wrap(obj, name, label):
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        with torch.profiler.record_function(SPAN + label):
            return fn(*a, **kw)

    setattr(obj, name, wrapped)


def _unwrap(obj, name):
    obj.__dict__.pop(name, None)


def _events(prof):
    """(device ops, host spans) of a finished profile: [(name, start_ns,
    end_ns)]."""
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns() if hasattr(e, "start_ns") else \
            int(e.start_us() * 1000)
        dur = e.duration_ns() if hasattr(e, "duration_ns") else \
            int(e.duration_us() * 1000)
        item = (name, start, start + dur)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith(SPAN):
                ops.append(item)
        elif name.startswith(SPAN):
            spans.append(item)
    return ops, spans


def traced(run, seconds, cell, params):
    """Run the window of `run` for `seconds` under the profiler; returns
    (Trace, the window's (t0, t_end, steps, durations)).  Raises
    ProfilerShort when two sessions in a row recorded fewer launches of a
    counted kernel than the port's counters."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sim = run.sim
    targets = [(sim.cc_data, "fill_BC_all", "fill_BC_all"),
               (sim, "compute_timestep", "compute_timestep"),
               (sim, "evolve", "evolve")]
    for obj, name, label in targets:
        _wrap(obj, name, label)
    if run.runner is not None:
        _wrap(run, "_chunk", "chunk")
    try:
        for attempt, pad in enumerate(PAD_S):
            kept = len(run.records)
            before = run.counters()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(pad)
                with record_function(SPAN + "window"):
                    result = run.window(seconds)
                time.sleep(pad)
            after = run.counters()
            counts = {k: after[k] - before[k] for k in after}
            ops, spans = _events(prof)
            win = [s for s in spans if s[0] == SPAN + "window"]
            if not win:
                raise ProfilerShort("the profiler recorded no window span")
            lo, hi = win[0][1], win[0][2]
            inside = [(n, max(s, lo), min(e, hi)) for n, s, e in ops
                      if e > lo and s < hi]
            trace = Trace(inside, (lo, hi),
                          [(n[len(SPAN):], s, e) for n, s, e in spans
                           if n != SPAN + "window"],
                          result[2], counts, cell, params,
                          run.state().shape[0])
            seen = trace.seen()
            short = {k: (seen[k], counts[k]) for k in seen
                     if seen[k] < counts[k]}
            if not short:
                return trace, result
            if attempt + 1 == len(PAD_S):
                names = {}
                for n, _, _ in ops:
                    names[n[:60]] = names.get(n[:60], 0) + 1
                top = sorted(names.items(), key=lambda x: -x[1])[:8]
                raise ProfilerShort(
                    "the profiler recorded fewer launches than the port "
                    f"counted (seen, counted): {short}; it recorded "
                    f"{len(ops)} device operations, {len(inside)} inside "
                    f"the window, most often {top}")
            del run.records[kept:]
    finally:
        for obj, name, _ in targets:
            _unwrap(obj, name)
        _unwrap(run, "_chunk")
