"""Readings of the comparison that decides `correct`, for setting its
limits: the program's numbers and its control's on many seeds, and with
--faults the numbers of the program with each planted fault
(harness/faults.py), each run at the cell's own size and load, in one
process so that the kernels build once:

    python3 benchmark/control.py --workload <name> --seconds 2 \
        --seeds 11 12 13 [--faults [--fault-seconds 2]]

One JSON line a reading on standard output.  The control is the plain
reference computed one precision below the configuration's
(harness/spec.py LOWER) from the same inputs, judged by the same
comparison; it has to read above every limit the cell sets on one of its
numbers.  The benchmark's own runs (run.py) run none of this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, caches  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--faults", action="store_true")
    p.add_argument("--fault-seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(1, str(ROOT))
    caches(ROOT)

    from harness import faults, runner, spec

    cell = spec.Cell(ROOT, args.workload)
    kinds = [None] + (list(faults.KINDS) if args.faults else [])
    for seed in args.seeds:
        for kind in kinds:
            t = time.perf_counter()
            seconds = args.seconds if kind is None else args.fault_seconds
            result, _ = runner.run_cell(cell, seed, seconds, False,
                                        T_START, args.device, fault=kind,
                                        control=kind is None)
            row = {"workload": args.workload, "seed": seed,
                   "fault": kind, "correct": result["correct"],
                   "attempted": result["attempted"],
                   "program": {k: v["value"]
                               for k, v in result["checks"].items()},
                   "control": result.get("control"),
                   "seconds": time.perf_counter() - t}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
