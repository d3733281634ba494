"""One run of a cell: set-up, warm-up, the timed (or traced) window, the
device's readings, and the comparison with the plain reference."""

import gc

import torch

from harness import checks, faults, spec, tracing, window

__all__ = ["Context", "WindowData", "run_cell"]


class WindowData:
    """What the host clock took of the window."""

    def __init__(self, t0, t_end, steps, durations, zones, setup_s):
        self.t0, self.t_end, self.steps = t0, t_end, steps
        self.durations, self.zones, self.setup_s = durations, zones, setup_s


class Context:
    """What a metric's reader reads: `window` (WindowData) and, in a
    traced run, `trace` (tracing.Trace)."""

    def __init__(self, window_data, trace=None):
        self.window, self.trace = window_data, trace


def _failed_state(cell, state, names):
    """Whether the state holds a non-finite value, or a non-positive one
    in a variable the configuration keeps positive."""
    if not bool(torch.isfinite(state).all()):
        return True
    return any(bool((state[names.index(v)] <= 0).any())
               for v in cell.config.get("positive", []))


def _metrics(cell, entries, ctx):
    out = {}
    for m in entries:
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell, seed, seconds, trace, t_start, device="cuda", *,
             fault=None, control=False):
    """Run the cell once; returns the result's fields (correct, attempted,
    failed, metrics, device, breakdown, checks) and the rows of the
    comparison [(name, number, limit)].  `fault` plants a fault of
    harness.faults in the program; `control` adds the control's numbers
    (the reference one precision lower in the program's place) under
    "control"."""
    device = torch.device(device)
    params = cell.params(seed)
    pyro, start = window.setup(cell, params, device)
    if fault is not None:
        faults.plant(pyro.sim, fault)
    run = window.Run(cell, pyro, spec.check_index(cell.traffic, seed))
    run.warm()

    breakdown = None
    if trace:
        span = min(seconds, cell.traffic["trace_seconds"])
        tr, (t0, t_end, steps, durations) = tracing.traced(run, span, cell,
                                                           params)
        ctx = Context(WindowData(t0, t_end, steps, durations, run.zones,
                                 t0 - t_start), tr)
        metrics = _metrics(cell, cell.per_layer, ctx)
        breakdown = tr.breakdown()
        dev_extra = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
    else:
        t0, t_end, steps, durations = run.window(seconds)
        ctx = Context(WindowData(t0, t_end, steps, durations, run.zones,
                                 t0 - t_start))
        metrics = _metrics(cell, cell.end_to_end, ctx)
        dev_extra = {}

    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        kind = torch.cuda.get_device_name(device)
    else:
        peak, kind = 0, "cpu"
    failed = steps if _failed_state(cell, run.state(),
                                    pyro.sim.cc_data.names) else 0

    # the program's state is freed before the reference runs
    records = run.records
    del run, pyro
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = cell.reference()
    refs = checks.reference_side(ref, records, params, cell.dtype, device)
    got = checks.numbers(ref, records, start, params, cell.dtype, refs)
    correct, rows = checks.verdict(got, cell.limits)
    correct = correct and failed == 0

    result = {"correct": correct, "attempted": steps, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": peak, **dev_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        result["control"] = checks.control_numbers(
            ref, records, params, cell.dtype, spec.LOWER[cell.dtype],
            refs)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows
