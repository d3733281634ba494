"""The port's on-device chunked loop (driver_loop.run_sim_fast) on the CPU.

It holds the port's fast loop to its own host loop (Pyro.run_sim) -- the
three tests of tests/test_driver_loop.py at their tolerances, and by bits
in float64 where the tmax clamp allows -- and to the JAX package's
run_sim_fast at rtol 1e-12 with equal step counts and output steps, on the
compressible CTU solver (the ramp's moving shock front included),
advection and swe.  JAX's loop cannot carry swe's particles (it reads a
density index swe lacks), so swe with particles is held to the port's host
loop alone.  The refusals name their ROADMAP.md labels.  On the CPU a
chunk runs eagerly; the CUDA graph of a chunk is checked on the card
(chip_smoke.py phase 5g)."""

import glob
import os

import numpy as np
import pytest
import torch

from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.driver_loop import (dt_control, make_chunk_runner,
                                         run_sim_fast)
from pyro2_tpu_torch.mesh import boundary as bnd
from pyro2_tpu_torch.util import io_pyro

SOD = {"mesh.nx": 32, "mesh.ny": 8, "driver.tmax": 0.05,
       "particles.do_particles": 0}
TOPHAT = {"mesh.nx": 16, "mesh.ny": 16, "driver.tmax": 0.3,
          "particles.do_particles": 1, "particles.n_particles": 25,
          "particles.particle_generator": "grid"}
SWE_QUAD = {"mesh.nx": 16, "mesh.ny": 16, "driver.max_steps": 10,
            "particles.do_particles": 0}
# the dam breaks of the published inputs files, their grids, 12 steps
DAM = {"driver.max_steps": 12, "particles.do_particles": 0}
# the double Mach reflection at 24x8: the front sweeps the top ghosts
RAMP = {"mesh.nx": 24, "mesh.ny": 8, "driver.max_steps": 10,
        "particles.do_particles": 0}


def _run(solver, problem, inputs, chunk_steps=None, P=Pyro, **kw):
    """A run of `problem`, or of (problem, inputs file)."""
    p = P(solver, **kw)
    problem, inputs_file = problem if isinstance(problem, tuple) \
        else (problem, None)
    p.initialize_problem(problem, inputs_file=inputs_file,
                         inputs_dict=dict(inputs))
    if chunk_steps is None:
        p.run_sim()
    elif P is Pyro:
        run_sim_fast(p, chunk_steps=chunk_steps)
    else:
        from pyro2_tpu.driver_loop import run_sim_fast as jax_fast
        jax_fast(p, chunk_steps=chunk_steps)
    return p


def _host(solver, problem, inputs):
    return _run(solver, problem, inputs, device="cpu")


def _fast(solver, problem, inputs, chunk_steps):
    return _run(solver, problem, inputs, chunk_steps, device="cpu")


def _state(p):
    d = p.sim.cc_data.data
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


@pytest.mark.parametrize("chunk_steps", [4, 64])
def test_fast_loop_matches_host_loop(chunk_steps):
    """Same final state, t and n whether the chunk divides the run or
    overruns it (the JAX test's tolerances)."""
    ph = _host("compressible", "sod", SOD)
    pf = _fast("compressible", "sod", SOD, chunk_steps)
    assert pf.sim.n == ph.sim.n
    assert np.isclose(pf.sim.cc_data.t, ph.sim.cc_data.t, rtol=0,
                      atol=1e-14)
    np.testing.assert_allclose(_state(pf), _state(ph), rtol=1e-13,
                               atol=1e-14)


def test_fast_loop_particles_match_host():
    """Particles ride in the carry: positions and `active` after the fast
    loop equal the host loop's (advection tophat, grid particles)."""
    ph = _host("advection", "tophat", TOPHAT)
    pf = _fast("advection", "tophat", TOPHAT, 8)
    assert pf.sim.n == ph.sim.n
    np.testing.assert_allclose(pf.sim.particles.positions.numpy(),
                               ph.sim.particles.positions.numpy(),
                               rtol=1e-13, atol=1e-14)
    assert np.array_equal(pf.sim.particles.active.numpy(),
                          ph.sim.particles.active.numpy())
    np.testing.assert_allclose(_state(pf), _state(ph), rtol=1e-13,
                               atol=1e-14)


def _cadence(tmp_path, monkeypatch, sub, run):
    d = tmp_path / sub
    d.mkdir()
    monkeypatch.chdir(d)
    p = run()
    return p, sorted(glob.glob(str(d / "cad_*.h5")))


CADENCE = {**SOD, "driver.tmax": 0.08, "io.dt_out": 0.025,
           "io.basename": "cad_"}


def _cadence_run(P, chunk_steps, **kw):
    def run():
        p = P("compressible", **kw)
        p.initialize_problem("sod", inputs_dict=dict(CADENCE))
        p.rp.set_param("io.do_io", 1)     # library mode forces io off
        if chunk_steps is None:
            p.run_sim()
        elif P is Pyro:
            run_sim_fast(p, chunk_steps=chunk_steps)
        else:
            from pyro2_tpu.driver_loop import run_sim_fast as jax_fast
            jax_fast(p, chunk_steps=chunk_steps)
        return p
    return run


def test_fast_loop_output_cadence(tmp_path, monkeypatch):
    """The fast loop writes the same files (names, count, contents) as
    the host loop: a body freezes at an output-due step."""
    _, host_files = _cadence(tmp_path, monkeypatch, "host",
                             _cadence_run(Pyro, None, device="cpu"))
    _, fast_files = _cadence(tmp_path, monkeypatch, "fast",
                             _cadence_run(Pyro, 64, device="cpu"))
    assert [os.path.basename(f) for f in fast_files] == \
        [os.path.basename(f) for f in host_files]
    assert len(host_files) >= 4          # initial + >=2 cadence + final
    for hf, ff in zip(host_files, fast_files):
        sh = io_pyro.read(hf, device="cpu")
        sf = io_pyro.read(ff, device="cpu")
        assert sf.n == sh.n
        assert np.isclose(sf.cc_data.t, sh.cc_data.t, rtol=0, atol=1e-14)
        np.testing.assert_allclose(sf.cc_data.data.numpy(),
                                   sh.cc_data.data.numpy(), rtol=1e-13,
                                   atol=1e-14)


def test_fast_loop_matches_jax_output_steps(tmp_path, monkeypatch):
    """The port's run_sim_fast against the JAX package's: the same output
    steps (file names), the same n and t in each file, the states at rtol
    1e-12."""
    from pyro2_tpu import Pyro as JPyro

    _, tfiles = _cadence(tmp_path, monkeypatch, "port",
                         _cadence_run(Pyro, 8, device="cpu"))
    _, jfiles = _cadence(tmp_path, monkeypatch, "jax",
                         _cadence_run(JPyro, 8))
    assert [os.path.basename(f) for f in tfiles] == \
        [os.path.basename(f) for f in jfiles]
    for tf, jf in zip(tfiles, jfiles):
        ts = io_pyro.read(tf, device="cpu")
        js = io_pyro.read(jf, device="cpu")
        assert ts.n == js.n and ts.cc_data.t == js.cc_data.t
        np.testing.assert_allclose(ts.cc_data.data.numpy(),
                                   js.cc_data.data.numpy(), rtol=1e-12,
                                   atol=1e-14)


@pytest.mark.parametrize("solver,problem,inputs,chunk_steps", [
    ("compressible", "sod", SOD, 4),
    ("compressible", "sod", SOD, 64),
    ("advection", "tophat", TOPHAT, 8),
    ("compressible", "quad", {"mesh.nx": 16, "mesh.ny": 16,
                              "driver.max_steps": 12,
                              "particles.do_particles": 1,
                              "particles.particle_generator": "random",
                              "particles.n_particles": 30}, 5),
    ("swe", "quad", SWE_QUAD, 4),
    ("swe", ("dam", "inputs.dam.x"), DAM, 5),
    ("swe", ("dam", "inputs.dam.y"), DAM, 5),
    ("compressible", "ramp", RAMP, 4),
])
def test_fast_loop_matches_jax(solver, problem, inputs, chunk_steps):
    """n equal, state and particles at rtol 1e-12 against the JAX fast
    loop (the same seed for the random particles)."""
    from pyro2_tpu import Pyro as JPyro

    np.random.seed(4)
    pt = _fast(solver, problem, inputs, chunk_steps)
    np.random.seed(4)
    pj = _run(solver, problem, inputs, chunk_steps, P=JPyro)
    assert pt.sim.n == pj.sim.n
    assert np.isclose(pt.sim.cc_data.t, pj.sim.cc_data.t, rtol=1e-14)
    np.testing.assert_allclose(_state(pt), _state(pj), rtol=1e-12,
                               atol=1e-14)
    if inputs["particles.do_particles"]:
        np.testing.assert_allclose(pt.sim.particles.positions.numpy(),
                                   np.asarray(pj.sim.particles.positions),
                                   rtol=1e-12)
        assert np.array_equal(pt.sim.particles.active.numpy(),
                              np.asarray(pj.sim.particles.active))


@pytest.mark.parametrize("chunk_steps", [4, 64])
def test_fast_and_host_loops_agree_by_bits(chunk_steps):
    """float64: the fast loop's n, t, state and particles are the host
    loop's bits (sod with grid particles; every step's tmax clamp agrees
    here)."""
    inputs = {**SOD, "particles.do_particles": 1,
              "particles.particle_generator": "grid",
              "particles.n_particles": 16}
    ph = _host("compressible", "sod", inputs)
    pf = _fast("compressible", "sod", inputs, chunk_steps)
    assert pf.sim.n == ph.sim.n
    assert pf.sim.cc_data.t == ph.sim.cc_data.t
    assert np.array_equal(_state(pf), _state(ph))
    assert np.array_equal(pf.sim.particles.positions.numpy(),
                          ph.sim.particles.positions.numpy())


@pytest.mark.parametrize("solver,problem,inputs,chunk_steps", [
    ("swe", "quad", SWE_QUAD, 4), ("swe", "quad", SWE_QUAD, 64),
    ("compressible", "ramp", RAMP, 3)])
def test_fast_and_host_loops_agree_by_bits_on_swe_and_the_ramp(
        solver, problem, inputs, chunk_steps):
    """float64: swe quad and the ramp, whose top ghosts the fast loop
    fills from the t it carries, give the host loop's n, t and state
    bits."""
    ph = _host(solver, problem, inputs)
    pf = _fast(solver, problem, inputs, chunk_steps)
    assert pf.sim.n == ph.sim.n == inputs["driver.max_steps"]
    assert pf.sim.cc_data.t == ph.sim.cc_data.t
    assert np.array_equal(_state(pf), _state(ph))


@pytest.mark.parametrize("generator,problem", [
    ("grid", "quad"), ("random", "quad"),
    ("grid", ("dam", "inputs.dam.x"))])
def test_swe_particles_fast_loop_matches_host(generator, problem):
    """float64: swe's particles ride in the carry, advanced with the
    momenta over the height after the step, as evolve advances them: the
    fast loop's positions, `active` and state are the host loop's bits
    (JAX's loop cannot carry swe's particles; ROADMAP.md C.4)."""
    inputs = {"driver.max_steps": 8, "particles.do_particles": 1,
              "particles.particle_generator": generator,
              "particles.n_particles": 36}
    if problem == "quad":
        inputs.update({"mesh.nx": 16, "mesh.ny": 16})
    else:
        # the break's waves reach the particles near the dam
        inputs.update({"driver.max_steps": 30, "particles.n_particles": 100})
    np.random.seed(7)
    ph = _host("swe", problem, inputs)
    np.random.seed(7)
    pf = _fast("swe", problem, inputs, 7)
    assert pf.sim.n == ph.sim.n == inputs["driver.max_steps"]
    assert pf.sim.cc_data.t == ph.sim.cc_data.t
    assert np.array_equal(_state(pf), _state(ph))
    assert np.array_equal(pf.sim.particles.positions.numpy(),
                          ph.sim.particles.positions.numpy())
    assert np.array_equal(pf.sim.particles.active.numpy(),
                          ph.sim.particles.active.numpy())
    np.random.seed(7)
    p0 = _run("swe", problem, {**inputs, "driver.max_steps": 0},
              device="cpu")
    assert not np.array_equal(pf.sim.particles.positions.numpy(),
                              p0.sim.particles.positions.numpy())


def test_tmax_clamp_differs_by_an_ulp_on_the_last_step():
    """Pinned: on tophat (dt 0.05, tmax 0.3) the host loop keeps dt = 0.05
    on the last step (t + dt is not above tmax), where the fast loop takes
    min(dt, tmax - t) = 0.3 - 0.25, an ulp less.  The states then differ
    in their last bits; the host loop's last step taken with tmax - t
    gives the fast loop's bits."""
    ph = _host("advection", "tophat", TOPHAT)
    pf = _fast("advection", "tophat", TOPHAT, 8)
    assert ph.sim.n == pf.sim.n == 6
    assert ph.sim.dt == 0.05 and 0.3 - 0.25 < 0.05
    assert not np.array_equal(_state(pf), _state(ph))

    p = Pyro("advection", device="cpu")
    p.initialize_problem("tophat", inputs_dict={**TOPHAT,
                                                "driver.max_steps": 5})
    p.run_sim()
    p.sim.cc_data.fill_BC_all()
    p.sim.compute_timestep()
    p.sim.dt = p.sim.tmax - p.sim.cc_data.t
    p.sim.evolve()
    assert np.array_equal(p.sim.cc_data.data.numpy(), _state(pf))
    assert np.array_equal(p.sim.particles.positions.numpy(),
                          pf.sim.particles.positions.numpy())


def _f32_pulse(tmp_path, monkeypatch, sub, chunk_steps, tmax, dt_out):
    """compressible acoustic_pulse 8^2 in float32 at fix_dt 2^-9 (every t
    short of the tmax clamp is exact in float32 and in double), output
    every dt_out; returns (n, output steps).  The fast loop's chunks are
    capped, so a loop that stops advancing fails instead of hanging."""
    from pyro2_tpu_torch.driver_loop import ChunkRunner

    call = ChunkRunner.__call__
    chunks = []

    def capped(self, carry):
        chunks.append(1)
        assert len(chunks) < 100, "the fast loop stopped advancing"
        return call(self, carry)

    monkeypatch.setattr(ChunkRunner, "__call__", capped)
    d = tmp_path / sub
    d.mkdir()
    monkeypatch.chdir(d)
    p = Pyro("compressible", device="cpu", dtype=torch.float32)
    p.initialize_problem("acoustic_pulse", inputs_dict={
        "mesh.nx": 8, "mesh.ny": 8, "driver.tmax": tmax,
        "driver.fix_dt": 2.0 ** -9, "io.dt_out": dt_out,
        "io.basename": "pulse_"})
    p.rp.set_param("io.do_io", 1)
    if chunk_steps is None:
        p.run_sim()
    else:
        run_sim_fast(p, chunk_steps=chunk_steps)
    files = sorted(glob.glob(str(d / "pulse_*.h5")))
    return p.sim.n, [int(os.path.basename(f)[6:10]) for f in files]


@pytest.mark.parametrize("chunk_steps", [16, 64])
def test_float32_tmax_that_rounds_down_ends_the_fast_loop(
        tmp_path, monkeypatch, chunk_steps):
    """float32, tmax 0.24 (whose float32 value is below 0.24): the last
    step lands t on float32(0.24), where the device's predicate says
    done; the host follows it, so the run ends, with the host loop's n
    and output steps (dt_out 0.03)."""
    host = _f32_pulse(tmp_path, monkeypatch, "host", None, 0.24, 0.03)
    fast = _f32_pulse(tmp_path, monkeypatch, "fast", chunk_steps, 0.24,
                      0.03)
    assert float(np.float32(0.24)) < 0.24
    assert fast == host
    assert host == (123, [0, 16, 31, 47, 62, 77, 93, 108, 123])


def test_float32_output_cadence_is_the_devices(tmp_path, monkeypatch):
    """float32, dt_out 0.0625 + 1e-10, whose float32 value is 0.0625: at
    t = 0.0625 (step 32) the device's predicate says an output is due
    where the host's double says not yet.  The host writes where the
    device froze -- steps 32, 64, 96 -- and the run goes on to the host
    loop's n; the host loop writes a step later."""
    dt_out = 0.0625 + 1e-10
    assert float(np.float32(dt_out)) == 0.0625
    fast = _f32_pulse(tmp_path, monkeypatch, "fast", 16, 0.25, dt_out)
    host = _f32_pulse(tmp_path, monkeypatch, "host", None, 0.25, dt_out)
    assert fast == (128, [0, 32, 64, 96, 128])
    assert host == (128, [0, 33, 65, 97, 128])


def _carry(sim):
    U = sim.cc_data.data
    i32 = {"dtype": torch.int32}
    parts = sim.particles
    if parts is None:
        pos, act = torch.zeros((0, 2), dtype=U.dtype), \
            torch.zeros((0,), dtype=torch.bool)
    else:
        pos, act = parts.positions.clone(), parts.active.clone()
    return [U.clone(), torch.tensor(sim.cc_data.t, dtype=U.dtype),
            torch.tensor(sim.n, **i32), torch.tensor(-1.e33, dtype=U.dtype),
            pos, act, torch.tensor(0, **i32), torch.tensor(-1, **i32)]


@pytest.mark.parametrize("solver,problem", [("compressible", "kh"),
                                            ("advection", "smooth"),
                                            ("swe", "quad"),
                                            ("compressible", "ramp")])
def test_a_chunk_reads_nothing_from_the_host(solver, problem, monkeypatch):
    """A chunk (the bodies the CUDA graph captures) converts no tensor to
    a Python value: with float(), int(), bool() and item() on tensors
    raising, a chunk still runs and advances n.  The ramp's fill computes
    its shock front from the carried t (its edges take no particles)."""
    ramp = problem == "ramp"
    p = Pyro(solver, device="cpu")
    p.initialize_problem(problem, inputs_dict={
        "mesh.nx": 24 if ramp else 16, "mesh.ny": 8 if ramp else 16,
        "particles.do_particles": int(not ramp),
        "particles.n_particles": 16, "particles.particle_generator": "grid"})
    runner = make_chunk_runner(p.sim, 3)
    carry = _carry(p.sim)

    def refuse(*args, **kw):
        raise AssertionError("a host read inside a chunk")

    for name in ("__float__", "__int__", "__bool__", "__index__", "item",
                 "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    carry = runner(carry)
    monkeypatch.undo()
    assert int(carry[2]) == 3 and runner.replays == 1
    assert make_chunk_runner(p.sim, 3) is runner


def test_dt_control_is_the_host_ladder():
    """The ladder on tensors: the first step's init_tstep_factor, then the
    max_dt_change cap, fix_dt, and the tmax clamp."""
    f64 = torch.float64
    kw = {"cfl": 0.8, "init_tstep_factor": 0.01, "max_dt_change": 2.0,
          "fix_dt": -1.0, "tmax": 1.0}
    raw, t = torch.tensor(0.5, dtype=f64), torch.tensor(0.0, dtype=f64)
    dt, old = dt_control(raw, t, torch.tensor(0), torch.tensor(9.0, dtype=f64),
                         **kw)
    assert float(dt) == 0.01 * (0.8 * 0.5) and float(old) == float(dt)
    dt, _ = dt_control(raw, t, torch.tensor(3), torch.tensor(0.1, dtype=f64),
                       **kw)
    assert float(dt) == 0.2
    dt, _ = dt_control(raw, torch.tensor(0.9, dtype=f64), torch.tensor(3),
                       torch.tensor(1.0, dtype=f64), **kw)
    assert float(dt) == 1.0 - 0.9
    dt, old = dt_control(raw, t, torch.tensor(3), torch.tensor(1.0, dtype=f64),
                         **{**kw, "fix_dt": 0.125})
    assert float(dt) == 0.125 and float(old) == 0.125


def test_ctu_step_takes_a_tensor_dt():
    """CTUStep with a 0-d tensor dt runs the plain step on the CPU with
    the float dt's bits, and leaves the kernel's by-value dt unset."""
    p = Pyro("compressible", device="cpu")
    p.initialize_problem("quad", inputs_dict={"mesh.nx": 16, "mesh.ny": 16})
    sim = p.sim
    sim.cc_data.fill_BC_all()
    sim.compute_timestep()
    U = sim.cc_data.data
    a = sim._step(U, 0.0, sim.dt)
    b = sim._step(U, torch.tensor(0.0, dtype=U.dtype),
                  torch.tensor(sim.dt, dtype=U.dtype))
    assert np.array_equal(a.numpy(), b.numpy())
    _, doubles, _ = sim._step.kernel_args(U, 0.0, torch.tensor(sim.dt))
    assert doubles[2] == 0.0
    _, doubles, _ = sim._step.kernel_args(U, 0.0, sim.dt)
    assert doubles[2] == sim.dt
    with pytest.raises(ValueError, match="CUDA tensor"):
        sim._step.launch(U, 0.0, torch.tensor(sim.dt, dtype=U.dtype))


@pytest.mark.parametrize("solver,problem", [
    ("burgers", "tophat"), ("advection_nonuniform", "slotted"),
    ("diffusion", "gaussian")])
def test_solvers_without_the_contract_raise_type_error(solver, problem):
    """No _dt_fn: TypeError, as the JAX package's loop raises."""
    p = Pyro(solver, device="cpu")
    p.initialize_problem(problem, inputs_dict={"mesh.nx": 16,
                                               "mesh.ny": 16})
    with pytest.raises(TypeError, match="kernel contract"):
        run_sim_fast(p)


@pytest.mark.parametrize("solver,problem,inputs", [
    ("compressible_rk", "sod", {}),
    ("compressible_fv4", "acoustic_pulse", {}),
    ("compressible_sdc", "acoustic_pulse", {}),
    ("compressible_react", "flame", {}),
    ("advection_rk", "smooth", {}), ("advection_fv4", "smooth", {}),
    ("advection_weno", "smooth", {})])
def test_uncovered_solvers_name_a28(solver, problem, inputs):
    """The subclasses whose evolve is not their step name ROADMAP.md
    A.28."""
    p = Pyro(solver, device="cpu")
    p.initialize_problem(problem, inputs_dict={"mesh.nx": 16,
                                               "mesh.ny": 16, **inputs})
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.28"):
        run_sim_fast(p)
    assert p.sim.n == 0


def test_a_fill_that_reads_t_on_the_host_names_a28(monkeypatch):
    """A ghost fill registered with reads_host_time (none of the port's
    is, since the ramp's front moved to the device) is refused, naming
    ROADMAP.md A.28."""
    p = Pyro("compressible", device="cpu")
    p.initialize_problem("sod", inputs_dict=SOD)
    assert not bnd.host_time_bcs
    monkeypatch.setattr(bnd, "host_time_bcs", {"outflow"})
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.28"):
        run_sim_fast(p)
    assert p.sim.n == 0


def test_swe_step_takes_a_tensor_dt():
    """SWEStep with a 0-d tensor dt runs the plain step on the CPU with
    the float dt's bits; its CUDA launch refuses a CPU tensor."""
    p = Pyro("swe", device="cpu")
    p.initialize_problem("quad", inputs_dict={"mesh.nx": 16, "mesh.ny": 16})
    sim = p.sim
    sim.cc_data.fill_BC_all()
    sim.compute_timestep()
    U = sim.cc_data.data
    a = sim._step(U, 0.0, sim.dt)
    b = sim._step(U, torch.tensor(0.0, dtype=U.dtype),
                  torch.tensor(sim.dt, dtype=U.dtype))
    assert np.array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(a.numpy(), U.numpy())
    with pytest.raises(ValueError, match="CUDA tensor"):
        sim._step.launch(U, 0.0, torch.tensor(sim.dt, dtype=U.dtype))
