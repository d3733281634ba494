"""The port's spans (pyro2_tpu_torch/util/profile_pyro.py) on the CPU.

Nothing is recorded outside a profiler session; inside one, a host step
records `step` with its fill, dt (and the dt's read) and evolve under it,
one step id throughout, and a diffusion step one `mg.cycle` a V-cycle and
one read more than its cycles.  A span's clock is the profiler's: it
contains a profiler range opened inside it.  No span reaches the
profiler's own events, nothing synchronizes, the buffer keeps the newest
MAXLEN spans, and TimerCollection's report nests its timers by parent."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.driver_loop import run_sim_fast
from pyro2_tpu_torch.multigrid import MG
from pyro2_tpu_torch.util import profile_pyro as pp

GRID = {"mesh.nx": 32, "mesh.ny": 32}
CASES = [("compressible", "quad"), ("diffusion", "gaussian")]


def _sim(solver, problem, **extra):
    p = Pyro(solver, device="cpu")
    p.initialize_problem(problem, inputs_dict={**GRID, **extra})
    return p


def _mark():
    return max((s.id for s in pp.spans()), default=0)


def _since(mark):
    return [s for s in pp.spans() if s.id > mark]


def _profiled(fn):
    """fn() under a CPU profiler session: (its spans, the profile)."""
    mark = _mark()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _since(mark), prof


def _events(prof):
    """[(name, start_ns, end_ns)] of the profiler's events."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() if hasattr(e, "start_ns") else \
            int(e.start_us() * 1000)
        dur = e.duration_ns() if hasattr(e, "duration_ns") else \
            int(e.duration_us() * 1000)
        out.append((e.name(), start, start + dur))
    return out


@pytest.mark.parametrize("solver, problem", CASES)
def test_nothing_is_recorded_outside_a_session(solver, problem):
    p = _sim(solver, problem)
    mark = _mark()
    p.single_step()
    p.single_step()
    assert _since(mark) == []


def test_a_quad_step_records_its_tree():
    p = _sim("compressible", "quad")
    p.single_step()
    n = p.sim.n
    spans, _ = _profiled(p.single_step)
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    (step,) = by_name["step"]
    assert step.parent is None and step.step == n
    for name in ("fill_BC_all", "compute_timestep", "evolve"):
        (s,) = by_name[name]
        assert s.parent == step.id
        assert step.t0_ns <= s.t0_ns <= s.t1_ns <= step.t1_ns
    (dt,) = by_name["read:dt"]
    assert dt.parent == by_name["compute_timestep"][0].id
    assert {s.step for s in spans} == {n}
    assert [s.name for s in spans if s.name.startswith("read:")] == \
        ["read:dt"]
    # ids are unique, and every parent is a span of the same step
    ids = {s.id for s in spans}
    assert len(ids) == len(spans)
    assert all(s.parent in ids for s in spans if s is not step)


def test_a_diffusion_step_reads_once_more_than_it_cycles():
    p = _sim("diffusion", "gaussian")
    p.single_step()
    cycles = MG.stats["cycles"]
    spans, _ = _profiled(p.single_step)
    cycles = MG.stats["cycles"] - cycles
    names = [s.name for s in spans]
    assert cycles > 0
    assert names.count("mg.cycle") == cycles
    assert names.count("mg.solve") == 1
    reads = [s for s in spans if s.name.startswith("read:")]
    assert len(reads) == 1 + cycles
    assert sorted({s.name for s in reads}) == ["read:norms",
                                                "read:source_norm"]
    by_id = {s.id: s for s in spans}
    for r in reads:
        if r.name == "read:norms":
            assert by_id[r.parent].name == "mg.cycle"


def test_a_span_contains_a_profiler_range_opened_inside_it():
    def fn():
        with pp.span("outer"):
            with record_function("inner_range"):
                time.sleep(0.002)

    spans, prof = _profiled(fn)
    (outer,) = [s for s in spans if s.name == "outer"]
    (inner,) = [e for e in _events(prof) if e[0] == "inner_range"]
    _, start, end = inner
    ms = 1_000_000
    assert outer.t0_ns - ms <= start <= outer.t0_ns + ms
    assert outer.t1_ns - ms <= end <= outer.t1_ns + ms
    assert end - start >= 2 * ms


@pytest.mark.parametrize("solver, problem", CASES)
def test_no_span_reaches_the_profilers_events(solver, problem):
    p = _sim(solver, problem)
    p.single_step()
    spans, prof = _profiled(p.single_step)
    assert spans
    names = {e[0] for e in _events(prof)}
    assert not names & {s.name for s in spans}


@pytest.mark.parametrize("loop", ["host", "device"])
def test_nothing_synchronizes(monkeypatch, loop):
    """The spans never synchronize; a run's end drains the device by one
    counted read, `read:final`."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(a))
    p = _sim("compressible", "quad", **{"driver.max_steps": 3})
    mark = _mark()
    with pp.recording():
        if loop == "host":
            p.run_sim()
        else:
            run_sim_fast(p, chunk_steps=2)
    assert calls == []
    spans = _since(mark)
    finals = [s for s in spans if s.name == "read:final"]
    assert len(finals) == 1
    if loop == "host":
        assert [s.name for s in spans].count("step") == 3
    else:
        assert [s.name for s in spans].count("chunk") == 2
        assert {"read:t", "read:n", "read:dt_old", "read:status"} <= \
            {s.name for s in spans}


def test_read_returns_the_value():
    with pp.recording():
        assert pp.read(torch.tensor(2.5), "x") == 2.5
        assert pp.read(torch.tensor([1, 2], dtype=torch.int32),
                       "x") == [1, 2]
        assert pp.read(torch.tensor(True), "x") is True


def test_the_buffer_keeps_the_newest_spans():
    mark = _mark()
    with pp.recording():
        for _ in range(pp.MAXLEN + 10):
            with pp.span("x"):
                pass
    kept = pp.spans()
    assert len(kept) == pp.MAXLEN
    assert kept[0].id == mark + 11 and kept[-1].id == mark + pp.MAXLEN + 10


def test_the_report_nests_by_parent(capsys):
    tc = pp.TimerCollection()
    with pp.recording():
        a = tc.timer("a")
        b = tc.timer("b")
        for _ in range(2):
            a.begin()
            b.begin()
            b.end()
            a.end()
        b.begin()
        b.end()
    tc.report()
    lines = capsys.readouterr().out.splitlines()
    rows = [(len(line) - len(line.lstrip()), line.split()[0],
             int(line.split()[-1])) for line in lines]
    assert rows == [(0, "a", 2), (2, "b", 2), (0, "b", 1)]
    # a collection reports only what was recorded after it was made
    pp.TimerCollection().report()
    assert capsys.readouterr().out == ""


def test_a_verbose_run_reports_its_spans(capsys):
    p = _sim("compressible", "quad", **{"driver.max_steps": 2,
                                        "driver.verbose": 1})
    p.run_sim()
    rows = [line for line in capsys.readouterr().out.splitlines()
            if line.rstrip().endswith(tuple("0123456789")) and " s " in line]
    tree = [(len(r) - len(r.lstrip()), r.split()[0], int(r.split()[-1]))
            for r in rows]
    assert tree[:2] == [(0, "main", 1), (2, "step", 2)]
    assert (4, "evolve", 2) in tree and (6, "read:dt", 2) in tree
