"""Device time of kernels and serial solver steps on one GPU.

    python3 pyro2_tpu_torch/util/kernel_profile.py [--root DIR] [--reps N]

Measures, in float32, the package under DIR (default: the checkout this
file lies in), so that two checkouts can be timed in turns in one run on
one card:

  * lm_mac, lm_rho and lm_states on the arguments lm_atm bubble 1024^2
    hands them after 3 steps;
  * mg_correct on random one-ghost blocks of 1024^2, 512^2 and 256^2 (the
    sharded diffusion's levels on a 1 x 1 mesh);
  * the rk stage increment (k_rk) of quad 1024^2 and the fv4 one (k_fv4)
    of acoustic_pulse 1024^2, each after 3 steps;
  * whole serial steps (Pyro.single_step) at 1024^2: compressible_rk quad,
    compressible_fv4 and compressible_sdc acoustic_pulse, incompressible
    and incompressible_viscous shear, burgers_viscous tophat.

For each call: the device kernels torch.profiler records (name and count a
call) and their device us a call, the CUDA-event ms a call, and the peak
device memory a call allocates above what was allocated before it.  The
last line of its output is one JSON object of these numbers, with the
card's name.  It needs a GPU and exits non-zero without one.
"""

import argparse
import json
import os
import sys
import time


def _profiled(fn, reps, tries=3):
    """[(kernel, count, device us)] of `reps` calls of fn under
    torch.profiler (a session that records no device kernel is made again,
    up to `tries` times; empty if none does)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        rows = []
        for e in prof.key_averages():
            us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0))
            if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
                rows.append((e.key, e.count, us))
        if rows:
            return rows
    return []


def _event_ms(fn, reps):
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _peak_bytes(fn):
    """The peak device bytes a call of fn allocates above what was
    allocated before it."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def measure(name, fn, reps):
    """The numbers of one call of fn, printed and returned."""
    rows = _profiled(fn, reps)
    kernels = {k[:60]: n / reps for k, n, _ in rows}
    us = sum(u for _, _, u in rows) / reps if rows else None
    ms = _event_ms(fn, reps)
    peak = _peak_bytes(fn)
    print(f"  {name}: device {us if us is None else round(us, 3)} us a "
          f"call in {kernels}; CUDA events {ms:.4f} ms a call; peak "
          f"{peak} B", flush=True)
    return {"device_us": us, "kernels": kernels, "event_ms": ms,
            "peak_bytes": peak}


def bubble_calls(n, steps=3):
    """(grid, {stage: (dt, planes)}) as lm_atm bubble's step at n^2 calls
    the stages on the card, after `steps` steps."""
    import torch

    from pyro2_tpu_torch import Pyro

    p = Pyro("lm_atm", device="cuda", dtype=torch.float32)
    p.initialize_problem("bubble", inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": 10 ** 6,
        "driver.tmax": 1.0e30})
    for _ in range(steps):
        p.single_step()
    lm, calls = p.sim.lm, {}

    class Recorder:
        g = lm.g

        def mac_vels(self, dt, *planes):
            calls["lm_mac"] = (dt, planes)
            return lm.mac_vels(dt, *planes)

        def rho_increment(self, dt, *planes):
            calls["lm_rho"] = (dt, planes)
            return lm.rho_increment(dt, *planes)

        def advect_terms(self, dt, *planes):
            calls["lm_states"] = (dt, planes)
            return lm.advect_terms(dt, *planes)

    p.sim.lm = Recorder()
    p.single_step()
    p.sim.lm = lm
    return lm, calls


# the serial steps timed: (solver, problem, steps a measured call)
SERIAL_STEPS = (("compressible_rk", "quad", 5),
                ("compressible_fv4", "acoustic_pulse", 5),
                ("compressible_sdc", "acoustic_pulse", 2),
                ("incompressible", "shear", 3),
                ("incompressible_viscous", "shear", 2),
                ("burgers_viscous", "tophat", 3))


def serial_pyro(solver, problem, n, steps=3):
    """Pyro(solver) on problem at n^2, CUDA float32, after `steps`
    steps."""
    import torch

    from pyro2_tpu_torch import Pyro

    p = Pyro(solver, device="cuda", dtype=torch.float32)
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": n, "mesh.ny": n, "driver.max_steps": 10 ** 6,
        "driver.tmax": 1.0e30})
    for _ in range(steps):
        p.single_step()
    return p


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_profile: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from pyro2_tpu_torch.multigrid import mg_kernel
    from pyro2_tpu_torch.multigrid import sharded_mg_kernel as smk
    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel
    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel

    print(f"kernel_profile of {os.path.abspath(args.root)} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for module in (lm_kernel, smk, mol_kernel, mg_kernel):
        module.build()
        module._load()
    out = {}
    lm, calls = bubble_calls(1024)
    for name, launch in (("lm_mac", lm.launch_mac),
                         ("lm_rho", lm.launch_rho),
                         ("lm_states", lm.launch_states)):
        dt, planes = calls[name]
        out[name] = measure(f"{name} bubble 1024^2", lambda: launch(
            dt, *planes), args.reps)
    rng = np.random.default_rng(23)
    for n in (1024, 512, 256):
        v = torch.as_tensor(rng.standard_normal((n + 2, n + 2)),
                            dtype=torch.float32, device="cuda")
        vc = torch.as_tensor(0.1 * rng.standard_normal(
            (n // 2 + 2, n // 2 + 2)), dtype=torch.float32, device="cuda")
        out[f"mg_correct {n}"] = measure(
            f"mg_correct {n}^2", lambda: smk.launch_correct(v, vc),
            args.reps)
    for solver, problem in (("compressible_rk", "quad"),
                            ("compressible_fv4", "acoustic_pulse")):
        sim = serial_pyro(solver, problem, 1024).sim
        sim.cc_data.fill_BC_all()
        sim.compute_timestep()
        U, t, dt, step = sim.cc_data.data, sim.cc_data.t, sim.dt, sim._step
        out[f"{step.name} {problem} 1024"] = measure(
            f"{step.name} {problem} 1024^2", lambda: step.launch(U, t, dt),
            args.reps)
    for solver, problem, steps in SERIAL_STEPS:
        p = serial_pyro(solver, problem, 1024, 1)
        out[f"{solver} {problem} 1024 step"] = measure(
            f"{solver} {problem} 1024^2, one serial step", p.single_step,
            steps)
    print(json.dumps({"root": os.path.abspath(args.root),
                      "device": torch.cuda.get_device_name(0),
                      "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
