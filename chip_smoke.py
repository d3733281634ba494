#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA CTU kernel from pyro2_tpu_torch/csrc with nvcc;
  3. the kernel against its plain PyTorch version on the card, one step
     from the same state, for five configurations at a ragged 200x136 and at
     1024^2, in float64 (max |diff| <= 1e-12 max|U|) and float32
     (<= 1e-5 max|U|);
  4. the main path through Pyro("compressible") -> run_sim on CUDA in
     float32: quad at 1024^2 for 100 steps and rt at 256x768 for 50 steps,
     each with the launch count reset just before and read just after;
  5. CUDA-event timing of the kernel and the plain step at quad 1024^2
     float32, beside the kernel's bound on this card;
  6. a torch.profiler breakdown of 20 main-path steps: device time by
     kernel and the device's busy share of the wall time.

The line before the last is a JSON object describing every kernel; the last
line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# data-sheet peaks (dense, no sparsity): memory bytes/s and float32
# (non-tensor-core) operations/s, by the name nvidia-smi reports
PEAKS = (("H100 PCIe", 2.0e12, 51.2e12),
         ("H100 NVL", 3.9e12, 60.0e12),
         ("H100", 3.35e12, 66.9e12),
         ("H200", 4.8e12, 66.9e12))

# one step each: (name, problem, inputs, extra passive scalars)
CONFIGS = (
    ("sod_cgf_lim1", "sod", {"compressible.riemann": "CGF",
                             "mesh.ymax": 1.0}, None),
    ("quad_hllc", "quad", {}, None),
    ("kh_hllc_lm_periodic", "kh", {"compressible.riemann": "HLLC_lm"}, None),
    ("rt_gravity_hse", "rt", {}, None),
    ("walls_floor_sponge_scalar", "quad", {
        "mesh.xlboundary": "reflect", "mesh.xrboundary": "reflect",
        "mesh.ylboundary": "reflect", "mesh.yrboundary": "reflect",
        "compressible.riemann": "CGF", "compressible.small_dens": 0.2,
        "compressible.grav": -0.5, "sponge.do_sponge": 1,
        "sponge.sponge_rho_begin": 0.6, "sponge.sponge_rho_full": 0.3},
     ["passive"]),
)


def log(*a):
    print(*a, flush=True)


def make_sim(problem, inputs, dtype, extra_vars=None):
    import numpy as np

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.solvers.compressible.simulation import Simulation

    p = Pyro("compressible", device="cuda", dtype=dtype)
    p.initialize_problem(problem, inputs_dict=inputs)
    if not extra_vars:
        return p.sim
    sim = Simulation("compressible", problem, p.problem_func, p.rp,
                     device="cuda", dtype=dtype)
    sim.initialize(extra_vars=extra_vars)
    rng = np.random.default_rng(5)
    dens = sim.cc_data.get_var("density").cpu().numpy()
    for name in extra_vars:
        sim.cc_data.set_var(name, dens * rng.random(dens.shape))
    sim.cc_data.t = 0.0
    return sim


def interior(U, g):
    return U[..., g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]


def compare(name, problem, inputs, extra, nx, ny, dtype, tol):
    """Kernel vs plain step from the same state after 3 kernel steps."""
    import torch

    sim = make_sim(problem, {"mesh.nx": nx, "mesh.ny": ny, **inputs},
                   dtype, extra)
    for _ in range(3):
        sim.cc_data.fill_BC_all()
        sim.compute_timestep()
        sim.evolve()
    sim.cc_data.fill_BC_all()
    sim.compute_timestep()
    U, t, dt = sim.cc_data.data, sim.cc_data.t, sim.dt
    got = sim._step.launch(U, t, dt)
    ref = sim._step.plain(U, t, dt)
    torch.cuda.synchronize()
    g = sim.cc_data.grid
    a, b = interior(ref, g), interior(got, g)
    err = float((a - b).abs().max())
    scale = float(a.abs().max())
    ghosts = torch.equal(got[:, :g.ilo], U[:, :g.ilo]) and \
        torch.equal(got[:, :, g.jhi + 1:], U[:, :, g.jhi + 1:])
    ok = bool(torch.isfinite(b).all()) and err <= tol * scale and ghosts
    log(f"  {'ok ' if ok else 'BAD'} {name:27s} {nx}x{ny} "
        f"{str(dtype)[6:]:8s} max|diff| = {err:.3e}  "
        f"(tol {tol:g} x max|U| = {tol * scale:.3e}), ghosts kept: {ghosts}")
    if not ok:
        raise AssertionError(f"kernel disagrees with the plain step: {name}")
    return err


def main_path(problem, nx, ny, steps):
    """Pyro -> run_sim on CUDA float32; returns (pyro, seconds, launches)."""
    import torch

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.solvers.compressible import ctu_kernel

    p = Pyro("compressible")            # default device: CUDA, float32
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": nx, "mesh.ny": ny, "driver.max_steps": steps,
        "driver.tmax": 1.0e30})
    assert p.sim.cc_data.data.is_cuda
    assert p.sim.cc_data.data.dtype == torch.float32
    torch.cuda.synchronize()
    ctu_kernel.launches = 0
    t0 = time.perf_counter()
    p.run_sim()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n_launch = ctu_kernel.launches

    sim = p.sim
    g = sim.cc_data.grid
    dens = interior(sim.cc_data.data, g)[sim.ivars.idens]
    pres = interior(sim.cc_data.get_var("pressure"), g)
    if sim.n != steps or n_launch != steps:
        raise AssertionError(f"{problem}: {sim.n} steps, {n_launch} kernel "
                             f"launches, expected {steps} of each")
    for name, f in (("density", dens), ("pressure", pres)):
        if not bool(torch.isfinite(f).all()) or float(f.min()) <= 0.0:
            raise AssertionError(f"{problem}: {name} not finite and positive")
    zps = nx * ny * steps / seconds
    log(f"  {problem} {nx}x{ny} f32: {steps} steps in {seconds:.3f} s, "
        f"{1e3 * seconds / steps:.3f} ms/step, {zps:.4e} zone-updates/s, "
        f"kernel launches {n_launch}, t = {sim.cc_data.t:.6g}, "
        f"min rho {float(dens.min()):.6g}, min p {float(pres.min()):.6g}")
    return p, seconds, n_launch


def profile_steps(p, steps):
    """torch.profiler over `steps` main-path steps: device time by kernel
    and the device's busy share of the wall time."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    p.single_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            p.single_step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0.0))
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            m = re.search(r"(k_[a-z0-9]+)<(float|double)>", e.key)
            name = f"ctu_step.cu {m.group(1)}<{m.group(2)}>" if m \
                else e.key[:72]
            rows.append((dev_us, e.count, name))
    rows.sort(reverse=True)
    if not rows:
        raise AssertionError("the profiler recorded no device time")
    busy_us = sum(r[0] for r in rows)
    log(f"[profile: {steps} main-path steps, quad 1024^2 float32]")
    log(f"  wall {wall_us / steps:.1f} us/step, device busy "
        f"{busy_us / steps:.1f} us/step ({100 * busy_us / wall_us:.1f}% "
        f"busy, {100 - 100 * busy_us / wall_us:.1f}% idle)")
    for dev_us, count, name in rows[:14]:
        log(f"  {dev_us / steps:9.2f} us/step  {count // steps:3d}x  {name}")


def event_ms(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from pyro2_tpu_torch.solvers.compressible import ctu_kernel

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device 0: {kind}")

    # 2. build
    log("[build]")
    t0 = time.perf_counter()
    so, nvcc_s, ptxas = ctu_kernel.build(verbose=True)
    ctu_kernel._load()
    log(f"  built {os.path.relpath(so, HERE)} in {nvcc_s:.1f} s "
        f"(nvcc) / {time.perf_counter() - t0:.1f} s (with load)")
    for line in ptxas.splitlines():
        if "Compiling entry" in line or "registers" in line:
            log("  " + line.strip())

    # 3. kernel vs plain on the card
    log("[kernel vs plain step on the card]")
    main_err = None
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for nx, ny in ((200, 136), (1024, 1024)):
            for name, problem, inputs, extra in CONFIGS:
                err = compare(name, problem, inputs, extra, nx, ny, dtype,
                              tol)
                if (name == "quad_hllc" and nx == 1024 and
                        dtype == torch.float32):
                    main_err = err
            torch.cuda.empty_cache()

    # 4. the main path
    log("[main path: Pyro('compressible') -> run_sim, CUDA float32]")
    p, _, quad_launches = main_path("quad", 1024, 1024, 100)
    main_path("rt", 256, 768, 50)

    # 5. timing at the main path's shapes
    log("[timing: quad 1024^2 float32, CUDA events]")
    sim = p.sim
    sim.cc_data.fill_BC_all()
    sim.compute_timestep()
    U, t, dt = sim.cc_data.data, sim.cc_data.t, sim.dt
    step = sim._step
    event_ms(lambda: step.launch(U, t, dt), 3)          # warm up
    event_ms(lambda: step.plain(U, t, dt), 1)
    plain_a = event_ms(lambda: step.plain(U, t, dt), 5)
    kern_a = event_ms(lambda: step.launch(U, t, dt), 20)
    kern_b = event_ms(lambda: step.launch(U, t, dt), 20)
    plain_b = event_ms(lambda: step.plain(U, t, dt), 5)
    kern_ms = 0.5 * (kern_a + kern_b)
    plain_ms = 0.5 * (plain_a + plain_b)

    g = sim.cc_data.grid
    nbytes, nops = ctu_kernel.work(g.nx, g.ny, sim.ivars.nvar,
                                   torch.float32, step.with_sources)
    bw, fp32 = next((b, f) for key, b, f in PEAKS if key in kind)
    bytes_ms = 1e3 * nbytes / bw
    ops_ms = 1e3 * nops / fp32
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"  kernel {kern_ms:.4f} ms/step ({kern_a:.4f}, {kern_b:.4f}); "
        f"plain {plain_ms:.4f} ms/step ({plain_a:.4f}, {plain_b:.4f}); "
        f"speed-up {plain_ms / kern_ms:.2f}x")
    log(f"  bound {bound_ms:.4f} ms ({bound_by}): {nbytes} B at "
        f"{bw:.3g} B/s = {bytes_ms:.4f} ms, {nops} ops "
        f"({ctu_kernel.FLOPS_PER_ZONE}/zone) at {fp32:.3g} op/s = "
        f"{ops_ms:.4f} ms; kernel at {100 * bound_ms / kern_ms:.2f}% of it")

    # 6. where a main-path step's time goes
    profile_steps(p, 20)

    log(json.dumps({"kernels": [{
        "name": "ctu_step",
        "route": "cuda",
        "source": "pyro2_tpu_torch/csrc/ctu_step.cu",
        "replaces": "pyro2_tpu/solvers/compressible/pallas_step.py:603",
        "launches": quad_launches,
        "max_abs_err": main_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
