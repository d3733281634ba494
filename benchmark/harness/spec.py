"""A cell's files, found by the names in BENCHMARK.json.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
everything that belongs to one of them sits in a file of its own:

  benchmark/configs/<config>.json    the configuration as it is run
  benchmark/traffic/<traffic>.json   the grid, dtype, loop and window
  benchmark/reference/<config>.py    the configuration's plain reference
  benchmark/checks/<workload>.json   the limits of the comparison
  benchmark/metrics/<metric>.py      one reader a metric

so a later cell or metric adds files and entries and edits none.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np

__all__ = ["BENCH", "Cell", "LOWER", "check_index", "draws", "load_module",
           "ROOT"]

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# the precision one step below each precision a configuration states: the
# control of the comparison runs the reference in it
LOWER = {"float64": "float32", "float32": "bfloat16"}


def load_module(path, name):
    """Import the Python file `path` as a module named `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _json(path):
    with open(path) as f:
        return json.load(f)


def _applies(entry, workload):
    return "workloads" not in entry or workload in entry["workloads"]


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic,
    limits and metric entries; the reference and the readers are loaded on
    demand (`reference()`, `reader(name)`)."""

    def __init__(self, root, workload):
        self.root = Path(root)
        self.bench = self.root / "benchmark"
        spec = _json(self.root / "BENCHMARK.json")
        by_name = {w["name"]: w for w in spec["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.entry = by_name[workload]
        self.chips = self.entry["chips"]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _json(self.root / self.config_entry["file"])
        self.traffic = _json(self.bench / "traffic" /
                             f"{self.entry['traffic']}.json")
        self.limits = _json(self.bench / "checks" / f"{workload}.json")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if _applies(m, workload)]
        self.per_layer = [m for m in spec["per_layer"]
                          if _applies(m, workload)]

    @property
    def dtype(self):
        return self.traffic["dtype"]

    def reference(self):
        name = self.config["name"]
        return load_module(self.bench / "reference" / f"{name}.py",
                           "bench_reference_" + name.replace(".", "_"))

    def reader(self, metric):
        return load_module(self.bench / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_"))

    def params(self, seed):
        """The runtime parameters of a run: the configuration's, the
        traffic's grid, and the seed's draws."""
        p = dict(self.config["params"])
        p["mesh.nx"], p["mesh.ny"] = self.traffic["grid"]
        p.update(draws(self.config, seed))
        return p


def _rng(seed, stream):
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, stream]))


def draws(config, seed):
    """The parameters the seed draws: each key of the configuration's
    `draws`, uniform in its [low, high], in the order of the keys."""
    rng = _rng(seed, 0)
    return {k: float(rng.uniform(lo, hi))
            for k, (lo, hi) in sorted(config.get("draws", {}).items())}


def check_index(traffic, seed):
    """The step (host loop) or chunk (on-device loop) of the window whose
    input and output the comparison reads besides the last, drawn from
    the seed in the traffic's `check_draw` range [low, high]."""
    lo, hi = traffic["check_draw"]
    return int(_rng(seed, 1).integers(lo, hi + 1))
