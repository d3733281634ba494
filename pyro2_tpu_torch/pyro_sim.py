#!/usr/bin/env python3
"""The Pyro driver: solver/problem registry, param layering, run loop.

The port of pyro2_tpu/pyro_sim.py (Pyro, PyroBenchmark and the CLI main),
for the solvers in `valid_solvers`.  Runs on CUDA unless the caller passes
a device::

    python -m pyro2_tpu_torch.pyro_sim compressible quad inputs.quad \
        io.do_io=0
    python -m pyro2_tpu_torch.pyro_sim --device cpu --compare_benchmark \
        advection smooth inputs.smooth io.do_io=0 io.force_final_output=1
"""

import argparse
import importlib
import os

import pyro2_tpu_torch.util.profile_pyro as profile
from pyro2_tpu_torch.defaults import dtype as working_dtype
from pyro2_tpu_torch.defaults import resolve_device
from pyro2_tpu_torch.util import compare, msg
from pyro2_tpu_torch.util.runparams import RuntimeParameters, _get_val

valid_solvers = ["advection", "advection_nonuniform", "advection_rk",
                 "advection_fv4", "advection_weno", "burgers",
                 "burgers_viscous", "compressible", "compressible_rk",
                 "compressible_fv4", "compressible_sdc",
                 "compressible_react", "diffusion",
                 "incompressible", "incompressible_viscous", "lm_atm",
                 "swe"]


class Pyro:
    """The main driver: pairs a solver with a problem and runs it.

    `device` defaults to CUDA and raises when there is none; pass
    device="cpu" to run on the CPU.  `dtype` defaults to float32 on CUDA
    and float64 on the CPU."""

    def __init__(self, solver_name, *, from_commandline=False, device=None,
                 dtype=None):
        if from_commandline:
            msg.bold("pyro ...")

        if solver_name not in valid_solvers:
            msg.fail(f"ERROR: {solver_name} is not a valid solver")

        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device, dtype)
        self.from_commandline = from_commandline

        self.pyro_home = os.path.dirname(os.path.realpath(__file__)) + "/"
        solver_import = "pyro2_tpu_torch.solvers." + solver_name

        self.solver = importlib.import_module(solver_import)
        self.solver_name = solver_name

        self.problem_name = None
        self.problem_func = None
        self.problem_source = None
        self.problem_source_weight = None
        self.problem_params = None
        self.problem_finalize = None

        self.custom_problems = {}

        # layered runtime parameters: package defaults, then solver defaults
        self.rp = RuntimeParameters()
        self.rp.load_params(self.pyro_home + "_defaults")
        self.rp.load_params(self.pyro_home + "solvers/" + self.solver_name +
                            "/_defaults")

        self.tc = profile.TimerCollection()
        self.is_initialized = False

    def add_problem(self, name, problem_func, *, problem_params=None):
        """Register a custom problem setup for this solver."""
        if problem_params is None:
            problem_params = {}
        self.custom_problems[name] = (problem_func, problem_params)

    def initialize_problem(self, problem_name, *, inputs_file=None,
                           inputs_dict=None):
        """Set up the named problem: params, Simulation, initialize."""
        if problem_name in self.custom_problems:
            self.problem_name = problem_name
            self.problem_func, self.problem_params = \
                self.custom_problems[problem_name]
            self.problem_finalize = None
            self.problem_source = None
            self.problem_source_weight = None
        else:
            problem = importlib.import_module(
                f"pyro2_tpu_torch.solvers.{self.solver_name}.problems."
                f"{problem_name}")
            self.problem_name = problem_name
            self.problem_func = problem.init_data
            self.problem_params = getattr(problem, "PROBLEM_PARAMS", {})
            self.problem_finalize = problem.finalize
            self.problem_source = getattr(problem, "source_terms", None)
            self.problem_source_weight = getattr(problem, "source_weight",
                                                 None)

            if inputs_file is None:
                inputs_file = problem.DEFAULT_INPUTS

        for k, v in self.problem_params.items():
            self.rp.set_param(k, v, no_new=False)

        if inputs_file is not None:
            if not os.path.isfile(inputs_file):
                inputs_file = (self.pyro_home + "solvers/" +
                               self.solver_name + "/problems/" + inputs_file)
                if not os.path.isfile(inputs_file):
                    msg.fail("ERROR: inputs file does not exist")
            self.rp.load_params(inputs_file, no_new=1)

        # library mode: vis/io/verbose off by default
        if not self.from_commandline:
            self.rp.set_param("vis.dovis", 0)
            self.rp.set_param("driver.verbose", 0)
            self.rp.set_param("io.do_io", 0)

        if inputs_dict is not None:
            for k, v in inputs_dict.items():
                self.rp.set_param(k, v)

        self.rp.print_paramfile()

        self.verbose = self.rp.get_param("driver.verbose")
        self.dovis = self.rp.get_param("vis.dovis")

        self.sim = self.solver.Simulation(
            self.solver_name, self.problem_name, self.problem_func, self.rp,
            problem_finalize_func=self.problem_finalize,
            problem_source_func=self.problem_source,
            problem_source_weight_func=self.problem_source_weight,
            timers=self.tc, device=self.device, dtype=self.dtype)

        self.sim.initialize()
        self.sim.preevolve()

        if self.dovis:
            import matplotlib.pyplot as plt
            plt.ion()

        self.sim.cc_data.t = 0.0
        self.is_initialized = True

    def run_sim(self):
        """Evolve the entire simulation.  A verbose run records its spans
        and prints their report at the end."""
        if not self.is_initialized:
            msg.fail("ERROR: problem has not been initialized")

        with profile.recording(self.verbose > 0):
            tm_main = self.tc.timer("main")
            tm_main.begin()

            basename = self.rp.get_param("io.basename")
            do_io = self.rp.get_param("io.do_io")

            if do_io:
                self.sim.write(f"{basename}{self.sim.n:04d}")

            if self.dovis:
                import matplotlib.pyplot as plt
                plt.figure(num=1, figsize=(8, 6), dpi=100, facecolor="w")
                self.sim.dovis()

            while not self.sim.finished():
                self.single_step()

            force_final_output = self.rp.get_param("io.force_final_output")
            if do_io or force_final_output:
                if self.verbose > 0:
                    msg.warning("outputting...")
                self.sim.write(f"{basename}{self.sim.n:04d}")

            # the run ends when the device has: one read drains its queue
            profile.read(self.sim.cc_data.data.reshape(-1)[-1], "final")
            tm_main.end()

            if self.verbose > 0:
                self.rp.print_unused_params()
                self.tc.report()

        self.sim.finalize()

    def single_step(self):
        """fill BCs -> compute dt -> evolve -> output -> vis.  The first
        three run in a span `step` (step id sim.n), each in a span of its
        own."""
        if not self.is_initialized:
            msg.fail("ERROR: problem has not been initialized")

        with profile.span("step", step=self.sim.n):
            with profile.span("fill_BC_all"):
                self.sim.cc_data.fill_BC_all()
            with profile.span("compute_timestep"):
                self.sim.compute_timestep()
            with profile.span("evolve"):
                self.sim.evolve()

        if self.verbose > 0:
            print(f"{self.sim.n:5d} {self.sim.cc_data.t:10.5f} "
                  f"{self.sim.dt:10.5f}")

        if self.sim.do_output():
            if self.verbose > 0:
                msg.warning("outputting...")
            basename = self.rp.get_param("io.basename")
            self.sim.write(f"{basename}{self.sim.n:04d}")

        if self.dovis:
            tm_vis = self.tc.timer("vis")
            tm_vis.begin()
            self.sim.dovis()
            if self.rp.get_param("vis.store_images") == 1:
                import matplotlib.pyplot as plt
                basename = self.rp.get_param("io.basename")
                plt.savefig(f"{basename}{self.sim.n:04d}.png")
            tm_vis.end()

    def __repr__(self):
        return f"Pyro('{self.solver_name}')"

    def __str__(self):
        s = f"Solver = {self.solver_name}\n"
        if self.is_initialized:
            s += f"Problem = {self.sim.problem_name}\n"
            s += f"Simulation time = {self.sim.cc_data.t}\n"
            s += f"Simulation step number = {self.sim.n}\n"
        s += "\nRuntime Parameters\n------------------\n"
        s += str(self.rp)
        return s

    def get_var(self, v):
        """The simulation data tensor for variable name v."""
        if not self.is_initialized:
            msg.fail("ERROR: problem has not been initialized")
        return self.sim.cc_data.get_var(v)

    def get_grid(self):
        if not self.is_initialized:
            msg.fail("ERROR: problem has not been initialized")
        return self.sim.cc_data.grid

    def get_sim(self):
        return self.sim


class PyroBenchmark(Pyro):
    """Pyro with golden-file benchmarking (regression testing) hooks.

    The golden of a run is `solvers/<solver>/tests/<basename><n>.h5` under
    the package; it is read on the run's own device and dtype."""

    def __init__(self, solver_name, *, comp_bench=False,
                 reset_bench_on_fail=False, make_bench=False, device=None,
                 dtype=None):
        super().__init__(solver_name, device=device, dtype=dtype)
        self.comp_bench = comp_bench
        self.reset_bench_on_fail = reset_bench_on_fail
        self.make_bench = make_bench

    def run_sim(self, rtol=1.e-12):
        """Run; with comp_bench return compare's result (0 on a match),
        else the Simulation."""
        super().run_sim()

        result = 0
        if self.comp_bench:
            result = self.compare_to_benchmark(rtol)
        if self.make_bench or (result != 0 and self.reset_bench_on_fail):
            self.store_as_benchmark()
        if self.comp_bench:
            return result
        return self.sim

    def benchmark_file(self):
        """The golden's path (without .h5) for the run's step count."""
        basename = self.rp.get_param("io.basename")
        return (f"{self.pyro_home}solvers/{self.solver_name}/tests/"
                f"{basename}{self.sim.n:04d}")

    def compare_to_benchmark(self, rtol):
        import pyro2_tpu_torch.util.io_pyro as io
        compare_file = self.benchmark_file()
        msg.warning(f"comparing to: {compare_file} ")
        try:
            sim_bench = io.read(compare_file, device=self.device,
                                dtype=self.dtype)
        except OSError:
            msg.warning("ERROR opening compare file")
            return "ERROR opening compare file"

        result = compare.compare(self.sim.cc_data, sim_bench.cc_data, rtol)
        if result == 0:
            msg.success(f"results match benchmark to within relative "
                        f"tolerance of {rtol}\n")
        else:
            msg.warning("ERROR: " + compare.errors[result] + "\n")
        return result

    def store_as_benchmark(self):
        bench_file = self.benchmark_file()
        os.makedirs(os.path.dirname(bench_file), exist_ok=True)
        msg.warning(f"storing new benchmark: {bench_file}\n")
        self.sim.write(bench_file)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: cuda)")
    p.add_argument("--make_benchmark", action="store_true",
                   help="create a new benchmark file for regression testing")
    p.add_argument("--compare_benchmark", action="store_true",
                   help="compare the end result to the stored benchmark")
    p.add_argument("solver", metavar="solver-name", type=str, nargs=1,
                   help="name of the solver to use", choices=valid_solvers)
    p.add_argument("problem", metavar="problem-name", type=str, nargs=1,
                   help="name of the problem to run")
    p.add_argument("param", metavar="inputs-file", type=str, nargs=1,
                   help="name of the inputs file")
    p.add_argument("other", metavar="runtime-parameters", type=str, nargs="*",
                   help="additional runtime parameters that override the "
                        "inputs file in the format section.option=value")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    if args.compare_benchmark or args.make_benchmark:
        pyro = PyroBenchmark(args.solver[0],
                             comp_bench=args.compare_benchmark,
                             make_bench=args.make_benchmark,
                             device=args.device)
    else:
        pyro = Pyro(args.solver[0], from_commandline=True,
                    device=args.device)

    other = {}
    for param_string in args.other:
        k, v = param_string.split("=")
        other[k] = _get_val(v)

    pyro.initialize_problem(problem_name=args.problem[0],
                            inputs_file=args.param[0],
                            inputs_dict=other)
    return pyro.run_sim()


if __name__ == "__main__":
    main()
