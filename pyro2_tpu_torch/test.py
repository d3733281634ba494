#!/usr/bin/env python3
"""Regression-test driver: run the solver/problem suite against the stored
golden HDF5 benchmarks, plus the standalone multigrid analytic solves (the
port of pyro2_tpu/test.py).

The goldens are float64, so every run is float64, on the card by default
or on the CPU with --device cpu; each final state is compared zone by
zone at rtol (default 1e-12) with util/compare.py.  The goldens live under
each solver's tests/ directory of this package (--store_all_benchmarks
rewrites them).  The four analytic multigrid solves (MG_EXPECTED) run
after the 16 runs, or alone with --multigrid_only, in float64 on the same
device, and pass within 10% of their expected L2 error::

    python -m pyro2_tpu_torch.test --device cpu
    python -m pyro2_tpu_torch.test --device cpu --single advection-smooth
    python -m pyro2_tpu_torch.test --device cpu --multigrid_only
"""

import argparse
import datetime
import os
import sys
from pathlib import Path

import torch

import pyro2_tpu_torch.pyro_sim as pyro
from pyro2_tpu_torch.multigrid.examples import (
    mg_test_general_inhomogeneous, mg_test_simple, mg_test_vc_dirichlet,
    mg_test_vc_periodic)


class PyroTest:
    def __init__(self, solver, problem, inputs, options):
        self.solver = solver
        self.problem = problem
        self.inputs = inputs
        self.options = options

    def __str__(self):
        return f"{self.solver}-{self.problem}"


# expected L2 errors of the MG analytic solves (2nd-order truncation;
# the constant-coefficient values match the reference's
# multigrid/tests/mg_convergence.txt)
MG_EXPECTED = {
    "mg_poisson_dirichlet": (256, mg_test_simple.test_poisson_dirichlet,
                             1.60e-6),
    "mg_vc_poisson_dirichlet": (
        256, mg_test_vc_dirichlet.test_vc_poisson_dirichlet, 2.438e-5),
    "mg_vc_poisson_periodic": (
        256, mg_test_vc_periodic.test_vc_poisson_periodic, 2.438e-5),
    "mg_general_poisson_inhomogeneous": (
        256, mg_test_general_inhomogeneous.test_general_poisson_inhomogeneous,
        4.180e-6),
}


def run_test(t, reset_fails, store_all_benchmarks, rtol, device=None):
    """Run one test in test_outputs/<test>/; returns (name, result)."""
    orig_cwd = Path.cwd()
    test_dir = orig_cwd / f"test_outputs/{t}"
    test_dir.mkdir(parents=True, exist_ok=True)
    try:
        os.chdir(test_dir)
        p = pyro.PyroBenchmark(t.solver, comp_bench=not store_all_benchmarks,
                               reset_bench_on_fail=reset_fails,
                               make_bench=store_all_benchmarks,
                               device=device, dtype=torch.float64)
        p.initialize_problem(t.problem, inputs_file=t.inputs,
                             inputs_dict=t.options)
        err = p.run_sim(rtol)
        if store_all_benchmarks:
            err = 0
    finally:
        os.chdir(orig_cwd)

    if err == 0:
        basename = p.rp.get_param("io.basename")
        for fn in (test_dir / f"{basename}{p.sim.n:04d}.h5",
                   test_dir / "inputs.auto"):
            try:
                fn.unlink()
            except OSError:
                pass
        try:
            test_dir.rmdir()
            test_dir.parent.rmdir()
        except OSError:
            pass
    return str(t), err


def get_test_list():
    """The regression suite: the JAX package's 16 runs, inputs and
    options."""
    opts = {"driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0,
            "io.force_final_output": 1}
    tests = [
        PyroTest("advection", "smooth", "inputs.smooth", opts),
        PyroTest("advection_nonuniform", "slotted", "inputs.slotted", opts),
        PyroTest("advection_rk", "smooth", "inputs.smooth", opts),
        PyroTest("advection_fv4", "smooth", "inputs.smooth", opts),
        PyroTest("burgers", "test", "inputs.test", opts),
        PyroTest("compressible", "quad", "inputs.quad",
                 {**opts, "mesh.nx": 128, "mesh.ny": 128}),
        PyroTest("compressible", "sod", "inputs.sod.x", opts),
        PyroTest("compressible", "rt", "inputs.rt",
                 {**opts, "driver.tmax": 1.0}),
        PyroTest("compressible_rk", "rt", "inputs.rt",
                 {**opts, "driver.tmax": 0.5}),
        PyroTest("compressible_fv4", "acoustic_pulse",
                 "inputs.acoustic_pulse", opts),
        PyroTest("compressible_sdc", "acoustic_pulse",
                 "inputs.acoustic_pulse", opts),
        PyroTest("diffusion", "gaussian", "inputs.gaussian", opts),
        PyroTest("incompressible", "shear", "inputs.shear",
                 {**opts, "mesh.nx": 64, "mesh.ny": 64,
                  "driver.tmax": 0.2}),
        PyroTest("incompressible_viscous", "cavity", "inputs.cavity", opts),
        PyroTest("lm_atm", "bubble", "inputs.bubble",
                 {**opts, "mesh.nx": 64, "mesh.ny": 64,
                  "driver.max_steps": 20}),
        PyroTest("swe", "dam", "inputs.dam.x", opts),
    ]
    return tests


def do_tests(out_file, reset_fails=False, store_all_benchmarks=False,
             multigrid_only=False, single=None, solver=None, rtol=1e-12,
             device=None):
    """Run the selected tests; returns the number that failed."""
    results = {}
    tests = get_test_list()

    if not multigrid_only:
        if single is not None:
            tests_to_run = [q for q in tests if str(q) == single]
        elif solver is not None:
            tests_to_run = [q for q in tests if q.solver == solver]
        else:
            tests_to_run = tests

        for t in tests_to_run:
            print(f"running {t} ...")
            name, err = run_test(t, reset_fails, store_all_benchmarks, rtol,
                                 device=device)
            results[name] = err

    if (single is None and solver is None) or multigrid_only:
        for name, (N, fn, expected) in MG_EXPECTED.items():
            err = fn(N, verbose=0, device=device, dtype=torch.float64)
            # pass if within 10% of the expected truncation error
            results[name] = 0 if abs(err - expected) / expected < 0.1 \
                else f"L2 error {err:g} != expected {expected:g}"

    failed = sum(1 for r in results.values() if r != 0)
    out = [sys.stdout]
    if out_file is not None:
        out.append(open(out_file, "w"))

    for f in out:
        f.write("pyro2_tpu_torch tests run: {}\n\n".format(
            str(datetime.datetime.now().replace(microsecond=0))))
        for s, r in sorted(results.items()):
            if not r == 0:
                f.write(f"{s:42} failed! {r}\n")
            else:
                f.write(f"{s:42} passed\n")
        f.write(f"\n{failed} test(s) failed\n")

    if out_file is not None:
        out[1].close()
    return failed


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--outfile", type=str, default=None)
    p.add_argument("--store_all_benchmarks", action="store_true",
                   help="(re)generate all golden benchmark files")
    p.add_argument("--reset_failures", action="store_true")
    p.add_argument("--multigrid_only", action="store_true")
    p.add_argument("--single", type=str, default=None,
                   help="run a single test, e.g. compressible-sod")
    p.add_argument("--solver", type=str, default=None,
                   help="run all tests for one solver")
    p.add_argument("--rtol", type=float, default=1e-12)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")
    args = p.parse_args(argv)

    failed = do_tests(args.outfile,
                      reset_fails=args.reset_failures,
                      store_all_benchmarks=args.store_all_benchmarks,
                      multigrid_only=args.multigrid_only,
                      single=args.single, solver=args.solver,
                      rtol=args.rtol, device=args.device)
    sys.exit(failed)


if __name__ == "__main__":
    main()
