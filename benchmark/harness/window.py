"""Set-up, warm-up and the timed window of a cell.

The program is driven through its public entries: `Pyro(solver)` and
`initialize_problem`, then either the host loop, `Pyro.single_step`
(fill, CFL dt, evolve), or the on-device loop, the chunk runner that
`driver_loop.run_sim_fast` uses (`make_chunk_runner(sim, chunk_steps)`),
replayed chunk after chunk with the status read after each, as
`run_sim_fast` reads it.

Besides the times, a window keeps the input and output of the steps (or
chunks) that the comparison reads: the first warm-up step or chunk, whose
input is the problem's initial data; one drawn from the seed; and the
last of the window.  A step that replaces the state tensor leaves its
input intact, so the window holds a reference to it; one that writes the
state in place (diffusion) is given a copy each step.
"""

import time

import torch

__all__ = ["Record", "Run", "setup"]


class Record:
    """The input and output of `steps` consecutive steps: frames, and the
    loop's t, n and dt_old before them (floats on the host loop, 0-d
    tensors on the on-device loop); `dt` the program's last dt."""

    def __init__(self, inp, out, t, n, dt_old, steps, dt, device_dt):
        self.inp, self.out = inp, out
        self.t, self.n, self.dt_old = t, n, dt_old
        self.steps, self.dt, self.device_dt = steps, dt, device_dt


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(cell, params, device):
    """Build and initialize the cell's simulation: (pyro, a copy of the
    initial state)."""
    from pyro2_tpu_torch import Pyro

    dtype = getattr(torch, cell.dtype)
    pyro = Pyro(cell.config["solver"], device=device, dtype=dtype)
    pyro.initialize_problem(cell.config["problem"], inputs_dict=params)
    return pyro, pyro.sim.cc_data.data.clone()


class Run:
    """The loop of a cell on one initialized simulation: `warm()` runs the
    set-up's steps, `window(seconds)` the timed ones."""

    def __init__(self, cell, pyro, pick):
        self.pyro, self.sim = pyro, pyro.sim
        self.traffic = cell.traffic
        self.device = self.sim.cc_data.data.device
        self.loop = self.traffic["loop"]
        self.pick = pick
        self.records = []
        self.runner = self.carry = None
        self.inplace = None
        self.zones = self.traffic["grid"][0] * self.traffic["grid"][1]

    # -- the host loop -------------------------------------------------------
    def _step_record(self):
        """Run one step of the host loop and return its Record (copies)."""
        sim = self.sim
        inp = sim.cc_data.data.clone()
        meta = (sim.cc_data.t, sim.n, sim.dt_old)
        self.pyro.single_step()
        return Record(inp, sim.cc_data.data.clone(), *meta, 1, sim.dt,
                      False)

    def _warm_host(self):
        sim = self.sim
        before = sim.cc_data.data
        self.records.append(self._step_record())
        # does a step write the state in place?
        self.inplace = sim.cc_data.data is before
        for _ in range(self.traffic["warm_steps"] - 1):
            self.pyro.single_step()

    def _window_host(self, seconds):
        sim, step = self.sim, self.pyro.single_step
        durations = []
        _sync(self.device)
        t0 = last = time.perf_counter()
        k = 0
        while True:
            if k == self.pick:
                self.records.append(self._step_record())
            else:
                inp = sim.cc_data.data
                if self.inplace:
                    inp = inp.clone()
                meta = (sim.cc_data.t, sim.n, sim.dt_old)
                step()
            now = time.perf_counter()
            durations.append(now - last)
            last = now
            k += 1
            if sim.finished():
                raise RuntimeError("the run reached tmax or max_steps "
                                   "inside the window")
            if now - t0 >= seconds and k > self.pick:
                break
        _sync(self.device)
        t_end = time.perf_counter()
        durations[-1] += t_end - last
        if k - 1 != self.pick:
            self.records.append(Record(inp, sim.cc_data.data, *meta, 1,
                                       sim.dt, False))
        return t0, t_end, k, durations

    # -- the on-device loop --------------------------------------------------
    def _carry(self):
        """The first carry, as run_sim_fast makes it."""
        sim = self.sim
        U0 = sim.cc_data.data
        like = {"dtype": U0.dtype, "device": U0.device}
        as_int = {"dtype": torch.int32, "device": U0.device}
        return [U0.clone(), torch.tensor(sim.cc_data.t, **like),
                torch.tensor(sim.n, **as_int),
                torch.tensor(getattr(sim, "dt_old", 1.e33), **like),
                torch.zeros((0, 2), **like),
                torch.zeros((0,), dtype=torch.bool, device=U0.device),
                torch.tensor(sim.n_num_out, **as_int),
                torch.tensor(-1, **as_int)]

    def _chunk(self):
        """One chunk and the status read after it; (input copy, done)."""
        inp = [c.clone() for c in self.carry[:4]]
        self.carry = self.runner(self.carry)
        done = bool(self.runner.status(self.carry)[0])
        return inp, done

    def _restart(self):
        """A copy of the first carry, for the next problem (on the CPU the
        runner advances the carry it is given in place)."""
        return [c.clone() for c in self.first]

    def _chunk_record(self, inp):
        out = [c.clone() for c in self.carry[:4]]
        steps = int(out[2]) - int(inp[2])
        return Record(inp[0], out[0], inp[1], inp[2], inp[3], steps,
                      out[3], True)

    def _warm_device(self):
        from pyro2_tpu_torch import driver_loop

        self.runner = driver_loop.make_chunk_runner(
            self.sim, self.traffic["chunk_steps"])
        self.first = self._carry()
        self.carry = [c.clone() for c in self.first]
        for k in range(self.traffic["warm_chunks"]):
            inp, done = self._chunk()
            if k == 0:
                self.records.append(self._chunk_record(inp))
            if done:
                self.carry = self._restart()

    def _window_device(self, seconds):
        """Chunks until `seconds` have passed.  A chunk that ends the
        problem (t reaches tmax) is followed by the next problem from the
        initial carry, as a user runs one after another: the runner copies
        the carry it is given into its buffers."""
        n0 = int(self.carry[2])
        steps = 0
        _sync(self.device)
        t0 = time.perf_counter()
        k = 0
        while True:
            inp, done = self._chunk()
            if k == self.pick:
                self.records.append(self._chunk_record(inp))
            k += 1
            last = time.perf_counter() - t0 >= seconds and k > self.pick
            if done:
                steps += int(self.carry[2]) - n0
                if last:
                    break
                self.carry, n0 = self._restart(), int(self.first[2])
            elif last:
                break
        _sync(self.device)
        t_end = time.perf_counter()
        if not done:
            steps += int(self.carry[2]) - n0
        if k - 1 != self.pick:
            self.records.append(self._chunk_record(inp))
        return t0, t_end, steps, None

    # -- the entries ----------------------------------------------------------
    def warm(self):
        if self.loop == "host":
            self._warm_host()
        elif self.loop == "device":
            self._warm_device()
        else:
            raise ValueError(f"unknown loop {self.loop!r}")
        _sync(self.device)

    def window(self, seconds):
        """The timed window: (t0, t_end, steps, step durations or None)."""
        if self.loop == "host":
            return self._window_host(seconds)
        return self._window_device(seconds)

    def state(self):
        """The program's state after the window."""
        if self.loop == "device":
            return self.carry[0]
        return self.sim.cc_data.data

    def counters(self):
        """The port's own counters: kernel launches {kernel: count}, and
        the multigrid's solves and cycles.  On the on-device loop each body
        launches one k_ctu; the wrapper counts launches at the capture, the
        runner counts replays."""
        from pyro2_tpu_torch.multigrid import MG, mg_kernel
        from pyro2_tpu_torch.solvers.compressible import ctu_kernel

        counts = {"k_down": sum(n for k, n in mg_kernel.launches.items()
                                if k.startswith("mg_down")),
                  "k_up": sum(n for k, n in mg_kernel.launches.items()
                              if k.startswith("mg_up")),
                  "k_core": sum(n for k, n in mg_kernel.launches.items()
                                if k.startswith("mg_core")),
                  "solves": MG.stats["solves"],
                  "cycles": MG.stats["cycles"]}
        if self.runner is not None:
            counts["k_ctu"] = self.runner.replays * self.runner.chunk_steps
        else:
            counts["k_ctu"] = ctu_kernel.launches
        return counts
