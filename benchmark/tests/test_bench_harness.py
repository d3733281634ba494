"""The harness: BENCHMARK.json against the contract's names and limits,
every cell's files, the metric readers on a synthetic trace, the modules a
run may load, and whole runs of every cell on the CPU at a small grid,
sound and with a fault planted under them."""

import json
import re
import subprocess
import sys

import pytest
import torch

from harness import faults, runner, spec, tracing

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 31 + 5


def small(workload, n=32):
    cell = spec.Cell(ROOT, workload)
    cell.traffic["grid"] = [n, n]
    cell.config["params"]["driver.tmax"] = 1000.0
    return cell


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        names += [c["name"], *c["reduced"]]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for n in names:
        assert NAME.match(n), n
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_resolves_its_files(workload):
    cell = spec.Cell(ROOT, workload)
    ref = cell.reference()
    assert set(cell.limits) == set(ref.NUMBERS)
    assert cell.config["name"] == cell.entry["config"] == ref.NAME
    assert cell.traffic["loop"] in ("host", "device")
    for key in cell.config_entry["reduced"]:
        assert key in cell.config["changed"]
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
    assert "setup_s" in [m["name"] for m in cell.end_to_end]
    assert len(cell.end_to_end) >= 2 and cell.per_layer


class _Cell:
    dtype = "float32"
    traffic = {"grid": [1024, 1024]}


def synthetic():
    """A 1 ms window of two steps: per step one k_ctu of 200 us and a
    torch kernel of 50 us, and a memset of 10 us; a fill span over the
    first gap."""
    ms = 1_000_000
    ops = [("void (anonymous namespace)::k_ctu<float, 4>(float const*)",
            100_000, 300_000),
           ("void at::native::elementwise_kernel<128>()", 300_000, 350_000),
           ("Memset (Device)", 350_000, 360_000),
           ("void (anonymous namespace)::k_ctu<float, 4>(float const*)",
            500_000, 700_000),
           ("void at::native::elementwise_kernel<128>()", 700_000, 750_000),
           ("Memset (Device)", 750_000, 760_000)]
    spans = [("fill_BC_all", 0, 100_000), ("evolve", 360_000, 500_000)]
    return tracing.Trace(ops, (0, ms), spans, 2,
                         {"k_ctu": 2, "cycles": 12, "solves": 3}, _Cell(),
                         {"compressible.grav": 0.0}, 4)


def test_trace_arithmetic():
    t = synthetic()
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s() == pytest.approx(520e-6)
    assert t.kernel("k_ctu") == (2, pytest.approx(400e-6))
    assert t.seen()["k_ctu"] == 2
    b = t.breakdown()
    assert b["device_ops"][0] == ["k_ctu<float, 4>", pytest.approx(400e-6)]
    assert tracing.short_name(
        "void (anonymous namespace)::k_ctu<float, 4>(float const*)") == \
        "k_ctu<float, 4>"
    idle = dict(b["idle_gaps"])
    assert idle["host in fill_BC_all"] == pytest.approx(100e-6)
    assert idle["host in evolve"] == pytest.approx(140e-6)
    assert sum(idle.values()) == pytest.approx(480e-6)
    assert tracing.union_s([(0, 10), (5, 20), (30, 40)], 0, 35) == \
        pytest.approx(25e-9)


@pytest.mark.parametrize("metric, expect", [
    ("device_idle_pct", 48.0),
    ("kernels_per_step", 2.0),
    ("torch_op_us_per_step", 60.0),
    ("mg_cycles_per_solve", 4.0),
])
def test_readers_on_a_synthetic_trace(metric, expect):
    cell = spec.Cell(ROOT, WORKLOADS[0])
    got = cell.reader(metric).read(runner.Context(None, synthetic()))
    assert got == pytest.approx(expect)


def test_roofline_readers_on_a_synthetic_trace():
    from work import ctu, mg, roofline

    cell = spec.Cell(ROOT, WORKLOADS[0])
    t = synthetic()
    b, f = ctu.work(1024, 1024, 4, "float32")
    want = 100 * 2 * roofline.bound_s(b, f, "float32") / 400e-6
    got = cell.reader("ctu_roofline_pct").read(runner.Context(None, t))
    assert got == pytest.approx(want)
    # no multigrid kernel in the trace: nothing to read
    assert cell.reader("mg_roofline_pct").read(
        runner.Context(None, t)) is None
    t.ops = [("void k_down<float, 0>()", 0, 1000),
             ("void k_up<float, 0>()", 1000, 3000),
             ("void k_core<float>()", 3000, 4000)]
    per_cycle = sum(roofline.bound_s(*mg.work(e, n, mg.NSMOOTH, "float32",
                                              with_guess=g, want_r=r),
                                     "float32")
                    for e, n, g, r in mg.cycle_launches(1024, "float32"))
    got = cell.reader("mg_roofline_pct").read(runner.Context(None, t))
    assert got == pytest.approx(100 * 12 * per_cycle / 4e-6)


def test_host_clock_readers():
    cell = spec.Cell(ROOT, WORKLOADS[0])
    w = runner.WindowData(10.0, 12.0, 4, [0.4, 0.5, 0.5, 0.6], 1000, 7.5)
    ctx = runner.Context(w)
    assert cell.reader("zone_updates_per_s").read(ctx) == 2000.0
    assert cell.reader("setup_s").read(ctx) == 7.5
    assert cell.reader("step_ms_p95").read(ctx) == pytest.approx(585.0)
    w.durations = None
    assert cell.reader("step_ms_p95").read(ctx) is None


def test_no_forbidden_module_is_loaded():
    """The set-up code, the loops and the references import neither jax
    nor the JAX package (top-level names compared whole)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run\n"
        "from harness import runner, spec, tracing, window\n"
        "for w in %r:\n"
        "    c = spec.Cell(spec.ROOT, w); c.reference()\n"
        "    [c.reader(m['name']) for m in c.end_to_end + c.per_layer]\n"
        "import pyro2_tpu_torch\n"
        "from pyro2_tpu_torch import driver_loop\n"
        "from pyro2_tpu_torch.multigrid import MG, mg_kernel\n"
        "from pyro2_tpu_torch.solvers.compressible import ctu_kernel\n"
        "from pyro2_tpu_torch.solvers.diffusion import simulation\n"
        "print(run.forbidden_modules())\n"
        % (str(spec.BENCH), str(ROOT), WORKLOADS))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "pyro2_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax.numpy"]


def test_run_without_a_card_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, str(spec.BENCH / "run.py"), "--workload",
         WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_cpu_run_is_correct(workload):
    result, rows = runner.run_cell(small(workload), SEED, 0.3, False, 0.0,
                                   "cpu")
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"
    names = {m["name"] for m in spec.Cell(ROOT, workload).end_to_end}
    assert set(result["metrics"]) == names


def test_the_device_loop_runs_problem_after_problem():
    """At 32^2 a quad problem reaches the published tmax within two
    chunks: the window starts the next from its initial data, counts only
    the steps made, and what it produced stays correct."""
    cell = spec.Cell(ROOT, "quad-1024-f32-device")
    cell.traffic["grid"] = [32, 32]
    assert cell.config["params"]["driver.tmax"] == 0.8
    result, _ = runner.run_cell(cell, SEED, 2.0, False, 0.0, "cpu")
    assert result["correct"]
    chunk = cell.traffic["chunk_steps"]
    assert result["attempted"] % chunk != 0      # frozen bodies not counted


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", faults.KINDS)
def test_a_fault_under_the_run_is_caught(workload, fault):
    """The timed path broken underneath: a step that returns its state
    unchanged, or an answer altered where it is produced."""
    result, _ = runner.run_cell(small(workload), SEED, 0.2, False, 0.0,
                                "cpu", fault=fault)
    assert not result["correct"]
    assert result["checks"]["step_gap"]["value"] > \
        result["checks"]["step_gap"]["limit"]


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run_on_the_card(card, workload):
    """One short run of the command on the card: exit 0 and a result line
    that is correct (python -m pytest benchmark/tests -m card, on a
    machine with the card)."""
    out = subprocess.run(
        [sys.executable, str(spec.BENCH / "run.py"), "--workload", workload,
         "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
