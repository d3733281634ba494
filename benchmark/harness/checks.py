"""The comparison that decides `correct`.

The plain reference of the configuration (benchmark/reference/<config>.py)
works out again, from the program's input of each kept record, what the
program's steps produced: the ghost fill, the timestep, the step.  Three
kinds of number are compared, each against a limit of the cell
(benchmark/checks/<workload>.json):

  start_gap  per variable, max |program - reference| / max |reference| of
             the problem's initial data (ghosts included);
  step_gap   per variable, max |program - reference| over the interior of
             the records' outputs, over the largest change the reference
             makes to that variable in those steps: a step left undone
             reads 1, a zone altered reads its error over the step's
             change;
  dt_gap     |program's dt - reference's| / reference's, of each record's
             last step (where the timestep is a device computation).

Each is the worst over the records.  The control is the reference put in
the program's place and computed one precision lower (spec.LOWER): the
same numbers of its outputs must come out above the limits.
"""

import torch

__all__ = ["control_numbers", "numbers", "reference_side", "verdict"]

TINY = 1e-300


def _as(x, dtype):
    """A record's t, n or dt_old in the reference's precision."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    return x


def _frame_gap(a, b):
    """max over variables of max|a - b| / max|b| (float64)."""
    a, b = a.double(), b.double()
    worst = 0.0
    for v in range(a.shape[0]):
        scale = max(float(b[v].abs().max()), TINY)
        worst = max(worst, float((a[v] - b[v]).abs().max()) / scale)
    return worst


def _step_gap(out, ref_out, inp, ref, params):
    """max over variables of the interior's max|out - ref_out| over the
    interior's max|ref_out - inp|."""
    o = ref.interior(out, params).double()
    r = ref.interior(ref_out, params).double()
    i = ref.interior(inp, params).double()
    worst = 0.0
    for v in range(o.shape[0]):
        change = max(float((r[v] - i[v]).abs().max()), TINY)
        worst = max(worst, float((o[v] - r[v]).abs().max()) / change)
    return worst


def _advance(ref, rec, params, dtype):
    """The reference's (output frame, last dt) from the record's input,
    computed in `dtype`."""
    return ref.advance(rec.inp.to(dtype), _as(rec.t, dtype), rec.n,
                       _as(rec.dt_old, dtype), rec.steps, params,
                       rec.device_dt)


def _numbers(ref, params, start, outs, refs, records):
    """The numbers of one side: `start` its initial frame, `outs` its
    output frame and last dt of each record, `refs` the reference's."""
    start_ref = refs[0]
    got = {"start_gap": _frame_gap(start, start_ref),
           "step_gap": max(_step_gap(o, r, rec.inp, ref, params)
                           for (o, _), (r, _), rec in
                           zip(outs, refs[1], records))}
    if "dt_gap" in ref.NUMBERS:
        got["dt_gap"] = max(abs(float(d) - float(rd)) / abs(float(rd))
                            for (_, d), (_, rd) in zip(outs, refs[1]))
    return got


def reference_side(ref, records, params, dtype, device):
    """(initial frame, [(output frame, last dt)]) of the reference in the
    configuration's precision."""
    dt = getattr(torch, dtype)
    start = ref.initial(params, dt, device)
    return start, [_advance(ref, rec, params, dt) for rec in records]


def numbers(ref, records, start, params, dtype, refs=None):
    """The program's numbers: its initial frame `start` and the outputs
    of its records against the reference's."""
    refs = refs or reference_side(ref, records, params, dtype, start.device)
    outs = [(rec.out, rec.dt) for rec in records]
    return _numbers(ref, params, start, outs, refs, records)


def control_numbers(ref, records, params, dtype, lower, refs=None):
    """The control's numbers: the reference computed in the precision
    `lower` from the same inputs, judged by the same comparison."""
    device = records[0].inp.device
    refs = refs or reference_side(ref, records, params, dtype, device)
    low = getattr(torch, lower)
    start = ref.initial(params, low, device)
    outs = [_advance(ref, rec, params, low) for rec in records]
    return _numbers(ref, params, start, outs, refs, records)


def verdict(got, limits):
    """(correct, [(name, number, limit)]): every number at or under its
    limit, and finite."""
    rows = [(k, got[k], limits[k]["limit"]) for k in sorted(got)]
    ok = all(v == v and v <= lim for _, v, lim in rows)
    return ok, rows
