"""The benchmark of pyro2_tpu_torch on one NVIDIA card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (an entry of BENCHMARK.json's
`workloads`) names a configuration and a traffic mix; the run builds the
problem from the seed, warms up every shape it uses, then measures for
`--seconds` (with --trace 1, a bounded slice of that under the profiler),
compares what the window's steps produced with the configuration's plain
reference, and prints one JSON line last on standard output: correct,
attempted, failed, metrics (the end-to-end ones, or with --trace 1 the
per-layer ones), device, with --trace 1 breakdown, and last the numbers
compared with their limits (also the last lines of standard error).

It exits non-zero and prints no result when there is no CUDA card (or
fewer than the cell asks for), when the program cannot be imported, when
the traced run's profiler lost records, and when jax, jaxlib, flax or
the JAX package pyro2_tpu is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the top-level names no process of the benchmark may load
FORBIDDEN = {"jax", "jaxlib", "flax", "pyro2_tpu"}


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def caches(root):
    """Keep every build and kernel cache inside the checkout, at fixed
    paths; whatever the program writes to its working directory lands in
    a directory of the benchmark's own."""
    work = root / ".bench_run"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(work / sub)
    work.mkdir(exist_ok=True)
    os.chdir(work)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    sys.path.insert(1, str(ROOT))
    caches(ROOT)

    import torch

    from harness import runner, spec, tracing

    cell = spec.Cell(ROOT, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"no CUDA card for {args.workload}: it needs {cell.chips}",
              file=sys.stderr)
        return 3
    try:
        result, rows = runner.run_cell(cell, args.seed, args.seconds,
                                       bool(args.trace), T_START)
    except tracing.ProfilerShort as e:
        print(f"traced run failed: {e}", file=sys.stderr)
        return 5
    loaded = forbidden_modules()
    if loaded:
        print("forbidden modules loaded: " + ", ".join(loaded),
              file=sys.stderr)
        return 4
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
