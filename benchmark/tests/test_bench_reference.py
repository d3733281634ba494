"""The configurations' plain references (benchmark/reference/) against the
port's CPU path, and the comparison's verdicts on what is wrong.

On the CPU the port runs its plain PyTorch composition, in float64 here:
the references follow it over a few steps of each loop to rounding.  A
state altered in one zone, and a step computed one precision lower (the
control), must read above the cell's limits."""

import pytest
import torch

from harness import checks, spec, window

CPU = torch.device("cpu")
HOST = {"compressible.quad": "quad-4096-f32-host",
        "diffusion.gaussian": "gaussian-4096-f32-host"}
# how far the port's f64 steps may lie from the reference's: the CTU
# step is the same arithmetic; the multigrid stops at the residual rtol
# 1e-10 that the solver is given, the reference's solve at rounding
FOLLOWS = {"compressible.quad": 1e-14, "diffusion.gaussian": 1e-9}
WORKLOADS = ("quad-4096-f32-host", "gaussian-4096-f32-host",
             "quad-1024-f32-device", "gaussian-4096-f64-host")
SEED = 2 ** 31 + 11


def small(workload, n, dtype=None):
    """The cell at an n^2 grid (and another dtype), tmax out of reach."""
    cell = spec.Cell(spec.ROOT, workload)
    cell.traffic["grid"] = [n, n]
    if dtype:
        cell.traffic["dtype"] = dtype
    cell.config["params"]["driver.tmax"] = 1000.0
    return cell


def rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("config", sorted(HOST))
@pytest.mark.parametrize("n", [32, 64])
def test_reference_follows_the_host_loop(config, n):
    cell = small(HOST[config], n, "float64")
    params = cell.params(SEED)
    pyro, start = window.setup(cell, params, CPU)
    ref = cell.reference()
    assert torch.equal(ref.initial(params, torch.float64, CPU), start)
    steps = 4
    for _ in range(steps):
        pyro.single_step()
    out, dt = ref.advance(start, 0.0, 0, -1.e33, steps, params, False)
    assert rel(ref.interior(pyro.sim.cc_data.data, params),
               ref.interior(out, params)) <= FOLLOWS[config]
    assert abs(dt - pyro.sim.dt) <= 1e-14 * dt


@pytest.mark.parametrize("n", [32, 64])
def test_reference_follows_the_device_loop(n):
    from pyro2_tpu_torch import driver_loop

    cell = small("quad-1024-f32-device", n, "float64")
    params = cell.params(SEED)
    pyro, start = window.setup(cell, params, CPU)
    run = window.Run(cell, pyro, 0)
    carry = run._carry()
    inp = [c.clone() for c in carry[:4]]
    runner = driver_loop.make_chunk_runner(pyro.sim, 8)
    carry = runner(carry)
    ref = cell.reference()
    out, dt = ref.advance(inp[0], inp[1], inp[2], inp[3], 8, params, True)
    assert int(carry[2]) == 8
    assert rel(ref.interior(carry[0], params),
               ref.interior(out, params)) <= 1e-14
    assert abs(dt - float(carry[3])) <= 1e-14 * dt


def records(workload, n, seconds=0.2):
    """The kept records of a short CPU window of the cell at n^2, its
    initial frame and parameters."""
    cell = small(workload, n)
    params = cell.params(SEED)
    pyro, start = window.setup(cell, params, CPU)
    run = window.Run(cell, pyro, 1)
    run.warm()
    run.window(seconds)
    return cell, params, start, run.records


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_passes_and_alteration_fails(workload):
    cell, params, start, recs = records(workload, 32)
    ref = cell.reference()
    refs = checks.reference_side(ref, recs, params, cell.dtype, CPU)
    ok, _ = checks.verdict(checks.numbers(ref, recs, start, params,
                                          cell.dtype, refs), cell.limits)
    assert ok
    # one interior zone of the last output 10% off
    last = recs[-1]
    out = last.out.clone()
    i, j = out.shape[-2] // 2, out.shape[-1] // 3
    out[0, i, j] *= 1.1
    last.out = out
    got = checks.numbers(ref, recs, start, params, cell.dtype, refs)
    assert got["step_gap"] > cell.limits["step_gap"]["limit"]
    assert not checks.verdict(got, cell.limits)[0]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_in_lower_precision_fails(workload):
    """The reference one precision below the configuration's, in the
    program's place, fails the cell's limits (the control; on the card it
    runs at the cell's own size through benchmark/control.py)."""
    cell, params, start, recs = records(workload, 64)
    ref = cell.reference()
    got = checks.control_numbers(ref, recs, params, cell.dtype,
                                 spec.LOWER[cell.dtype])
    assert not checks.verdict(got, cell.limits)[0]
