"""On-device time loop: chunks of fill -> dt -> step with no host read.

The port of pyro2_tpu/driver_loop.py.  The host loop (`Pyro.run_sim`)
reads the CFL dt back from the device every step; here a whole chunk of
`chunk_steps` bodies -- ghost fill, CFL dt with the driver's timestep
ladder (init_tstep_factor, max_dt_change, fix_dt, the tmax clamp), the
solver's step and, with particles, their advance -- runs on the device,
and the host reads the carry only between chunks, for output and the
finished check.

On CUDA a chunk is one `torch.cuda.CUDAGraph`, captured once per
(simulation, chunk_steps) and replayed: the carry lives in static buffers
that each body copies its results into, and the step reads its dt from
device memory (`CTUStep` with a tensor dt launches `k_ctu`'s device-dt
entry, `SWEStep` `k_swe`'s).  Before the capture one body runs on a copy
of the carry, so the kernels build, each device-dt kernel opts into its
shared memory, and the caches (the weight plane, the geometry buffer, the
advection velocity planes, the ramp's front geometry) fill outside the
graph; the cyclic garbage collector runs before the capture and is held
off during it.  A failed capture raises; there is no fallback to the
step-by-step loop.  On the CPU the same bodies run eagerly in a Python
loop.

Output cadence is exact (simulation_null.do_output): a body freezes --
leaves the whole carry as it found it, by selection on the device --
once t >= tmax, n >= max_steps, or an output is due, so the host writes
the same files at the same steps as the host loop.  These predicates
(`ChunkRunner.status`) are evaluated on the carry, in its dtype, by the
bodies and by the host between chunks: in float32, t and the tmax and
dt_out it is compared with are float32 values on both sides, so the
host never waits for a step that the device has frozen.  The tmax clamp is
min(dt, tmax - t), as in the JAX package's loop, where the host loop sets
dt = tmax - t when t + dt > tmax: the two can differ by an ulp on the last
step.  t and dt are carried in the state's dtype, so an f32 run's dt is
an f32 value where the host loop's is a double.

Covered: the solvers that declare `device_loop` (the compressible CTU
solver, advection and swe, whose `evolve` is their step, particles
included), with every problem of theirs: the ramp's moving shock front is
computed on the device from the carried t (compressible/BC.py).  A solver
without `_dt_fn` raises TypeError, as in the JAX package; the others (the
RK, fv4, SDC, react and WENO subclasses) and a problem whose ghost fill
reads t on the host (a BC registered with reads_host_time; none of the
port's is) raise NotImplementedError naming ROADMAP.md A.28.
"""

import gc

import torch

from pyro2_tpu_torch.mesh import boundary as bnd
from pyro2_tpu_torch.util import msg, profile_pyro

__all__ = ["dt_control", "make_chunk_runner", "run_sim_fast"]


def dt_control(dt_raw, t, n, dt_old, *, cfl, init_tstep_factor,
               max_dt_change, fix_dt, tmax):
    """The driver.* timestep ladder on device tensors (NullSimulation.
    compute_timestep's).  Returns (dt, new_dt_old)."""
    if fix_dt > 0.0:
        dt = torch.full_like(dt_raw, fix_dt)
        new_old = dt
    else:
        dt = cfl * dt_raw
        dt = torch.where(n == 0, init_tstep_factor * dt,
                         torch.minimum(max_dt_change * dt_old, dt))
        new_old = dt
    dt = torch.minimum(dt, tmax - t)
    return dt, new_old


def _particle_velocity_fn(sim):
    """U -> (u, v): the velocity the solver's evolve advances its
    particles with, read from the state on the device."""
    vel = getattr(sim, "particle_velocity", None)
    if vel is None:
        raise NotImplementedError(
            f"{type(sim).__name__} has no pure particle-velocity "
            "extractor; use the standard host loop")
    return vel


def _covered(sim):
    """Raise unless the on-device loop computes what sim's evolve does."""
    name = type(sim).__name__
    module = type(sim).__module__
    step = getattr(sim, "_contract_step", None) or getattr(sim, "_step",
                                                           None)
    if step is None or not hasattr(sim, "_dt_fn"):
        raise TypeError(
            f"{module}.{name} does not expose the kernel contract "
            "(_step/_dt_fn) needed by the on-device loop")
    if not sim.device_loop:
        raise NotImplementedError(
            f"the on-device loop of {module}.{name}, whose evolve is not "
            "its step, waits for a later slice of the port (ROADMAP.md "
            "A.28)")
    datas = [sim.cc_data] + [getattr(sim, "aux_data", None)]
    for d in filter(None, datas):
        for bc in d.BCs.values():
            if {bc.xlb, bc.xrb, bc.ylb, bc.yrb} & bnd.host_time_bcs:
                raise NotImplementedError(
                    "the on-device loop of a ghost fill that reads t on "
                    "the host waits for a later slice of the port "
                    "(ROADMAP.md A.28)")
    return step


class ChunkRunner:
    """carry -> carry, up to chunk_steps steps; see make_chunk_runner.

    `replays` counts the chunks run; on CUDA `graph` is the captured chunk.
    The kernel wrappers count their launches at the capture (the warm-up
    body's and the chunk's), not at the replays."""

    def __init__(self, sim, chunk_steps):
        step = _covered(sim)
        self.chunk_steps = chunk_steps
        particles = getattr(sim, "particles", None)
        vel = _particle_velocity_fn(sim) if particles is not None else None

        dt_fn = sim._dt_fn
        fill = sim.cc_data.fill_bc_stack
        rp = sim.rp
        ladder = {"cfl": rp.get_param("driver.cfl"),
                  "init_tstep_factor": rp.get_param(
                      "driver.init_tstep_factor"),
                  "max_dt_change": rp.get_param("driver.max_dt_change"),
                  "fix_dt": rp.get_param("driver.fix_dt"),
                  "tmax": sim.tmax}
        tmax, max_steps = sim.tmax, sim.max_steps
        dt_out = rp.get_param("io.dt_out")
        n_out = rp.get_param("io.n_out")
        do_io = rp.get_param("io.do_io") == 1
        never = torch.zeros((), dtype=torch.bool,
                            device=sim.cc_data.data.device)

        def status(carry):
            """(done, output due) at the carry's (t, n), as 0-d bool
            tensors: finished()'s and do_output()'s predicates in the
            carry's dtype; last_out_n keeps the n_out branch from firing
            again at the step the host just wrote."""
            _, t, n, _, _, _, n_num_out, last_out_n = carry
            done = (t >= tmax) | (n >= max_steps)
            if not do_io:
                return done, never
            due = ((t >= (n_num_out + 1).to(t.dtype) * dt_out) |
                   ((n % n_out == 0) & (n > 0) & (n != last_out_n)))
            return done, due

        def body(carry):
            U, t, n, dt_old, pos, act = carry[:6]
            done, due = status(carry)
            frozen = done | due if do_io else done
            Uf = fill(U.clone(), t)
            dt, new_old = dt_control(dt_fn(Uf), t, n, dt_old, **ladder)
            U1 = step(Uf, t, dt)
            new = [U1, t + dt, n + 1, new_old]
            if particles is not None:
                # after the step, with the post-step velocity, as evolve
                new += particles.advance_pure(pos, act, *vel(U1), dt)
            # a frozen body leaves the carry as it found it
            for old, value in zip(carry, new):
                torch.where(frozen, old, value, out=old)

        self.status = status
        self.body = body
        self.replays = 0
        self.graph = None
        self.carry = None

    def _chunk(self, carry):
        for _ in range(self.chunk_steps):
            self.body(carry)

    def _capture(self, carry):
        """Warm one body up on a copy of the carry, then capture a chunk
        over the static buffers `carry`."""
        warm = [c.clone() for c in carry]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.body(warm)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()

        # an earlier runner's graph that the cyclic collector destroys
        # inside the capture frees its memory there, which invalidates the
        # capture (torch.cuda.graph no longer collects first): collect
        # before, and not during
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._chunk(carry)
        finally:
            if collecting:
                gc.enable()
        self.graph = graph

    def __call__(self, carry):
        """Advance the carry by one chunk, in a span `chunk`; returns the
        carry (on CUDA the runner's static buffers, which the values given
        are copied into)."""
        with profile_pyro.span("chunk"):
            carry = list(carry)
            if carry[0].device.type != "cuda":
                self._chunk(carry)
                self.replays += 1
                return carry
            if self.carry is None:
                self.carry = [c.clone() for c in carry]
                self._capture(self.carry)
            for static, value in zip(self.carry, carry):
                if value is not static:
                    static.copy_(value)
            self.graph.replay()
            self.replays += 1
            return self.carry


def make_chunk_runner(sim, chunk_steps):
    """The chunk runner of sim: carry -> carry, advancing up to
    chunk_steps steps.

    carry = [U, t, n, dt_old, pos, active, n_num_out, last_out_n], all
    device tensors: t and dt_old in the state's dtype, n and the output
    counters int32.  Steps freeze once t >= tmax, n >= max_steps or an
    output is due, so a chunk may overrun any of these.  On CUDA the
    runner is captured once per (sim, chunk_steps)."""
    runners = sim.__dict__.setdefault("_chunk_runners", {})
    if chunk_steps not in runners:
        runners[chunk_steps] = ChunkRunner(sim, chunk_steps)
    return runners[chunk_steps]


def run_sim_fast(pyro, *, chunk_steps=64):
    """Evolve pyro's simulation with the on-device chunked loop.

    The alternative to Pyro.run_sim for the covered solvers: the same dt
    ladder, the same output files (count, step numbers and contents),
    particles included; the host reads the device only between chunks.
    Returns the simulation."""
    sim = pyro.sim
    if not pyro.is_initialized:
        msg.fail("ERROR: problem has not been initialized")
    run_chunk = make_chunk_runner(sim, chunk_steps)

    tm_main = pyro.tc.timer("main")
    tm_main.begin()

    do_io = pyro.rp.get_param("io.do_io")
    basename = pyro.rp.get_param("io.basename")
    if do_io:
        sim.write(f"{basename}{sim.n:04d}")

    U0 = sim.cc_data.data
    like = {"dtype": U0.dtype, "device": U0.device}
    as_int = {"dtype": torch.int32, "device": U0.device}
    particles = getattr(sim, "particles", None)
    if particles is not None:
        pos0, act0 = particles.positions, particles.active
    else:
        pos0 = torch.zeros((0, 2), **like)
        act0 = torch.zeros((0,), dtype=torch.bool, device=U0.device)
    carry = [U0.clone(), torch.tensor(sim.cc_data.t, **like),
             torch.tensor(sim.n, **as_int),
             torch.tensor(getattr(sim, "dt_old", 1.e33), **like),
             pos0.clone(), act0.clone(),
             torch.tensor(sim.n_num_out, **as_int),
             torch.tensor(-1, **as_int)]

    # the device's predicates decide for the host (see the module's doc)
    done = profile_pyro.read(run_chunk.status(carry)[0], "status")
    while not done:
        carry = run_chunk(carry)
        U, t, n, dt_old, pos, act = carry[:6]
        sim.cc_data.data = U.clone()
        sim.cc_data.t = profile_pyro.read(t, "t")
        sim.n = profile_pyro.read(n, "n")
        sim.dt_old = profile_pyro.read(dt_old, "dt_old")
        if particles is not None:
            particles.positions, particles.active = pos.clone(), act.clone()

        if pyro.verbose > 0:
            print(f"{sim.n:5d} {sim.cc_data.t:10.5f}  (chunk of "
                  f"{chunk_steps})")
        done, due = profile_pyro.read(torch.stack(run_chunk.status(carry)),
                                      "status")
        if due:
            sim.n_num_out += 1
            sim.write(f"{basename}{sim.n:04d}")
            carry[6].fill_(sim.n_num_out)
            carry[7].fill_(sim.n)
        if pyro.dovis:
            sim.dovis()

    if do_io or pyro.rp.get_param("io.force_final_output"):
        sim.write(f"{basename}{sim.n:04d}")

    # the run ends when the device has: one read drains its queue
    profile_pyro.read(sim.cc_data.data.reshape(-1)[-1], "final")
    tm_main.end()
    sim.finalize()
    return sim
