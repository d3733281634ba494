"""The port's spans: named host intervals on the profiler's clock, and the
one helper through which the program waits for the device.

A span records its name, its own id, its parent's id (the span open
around it when it opened, or None), the step it belongs to (the `step`
span's `sim.n`, inherited by every span opened inside it) and its start
and end, `t0_ns` and `t1_ns`, from `time.time_ns()`: the clock on which a
`torch.profiler` session stamps its events, so spans can be laid beside
the device's operations of the same session.

Spans are recorded only while a `torch.profiler` session runs or inside
a `recording()` block.  Otherwise opening one costs one flag check and
keeps nothing.  A recorded span goes into a bounded buffer (`MAXLEN`
spans, the oldest dropped first) when it closes; `spans()` returns it.
A span never synchronizes, never reads the device and opens no profiler
range, so a session's device operations are the same with spans or
without.

`read(x, what)` is the one place where the program waits for the device:
it returns `x.tolist()` inside a span `read:<what>`, so the `read:*`
spans count the blocking device-to-host reads.

The program's spans and what each times:

  step              Pyro.single_step, the root of a host step
    fill_BC_all     the ghost fill
    compute_timestep  the CFL dt with the driver's ladder (read:dt)
    evolve          the solver's step
  mg.setup, rhs     diffusion's multigrid construction and right-hand side
  mg.solve          CellCenterMG2d.solve (read:source_norm is init_RHS's)
    mg.cycle        one V-cycle and its norms' read (read:norms)
  chunk             the on-device loop's copy-in and graph replay
  read:<what>       a blocking read (dt, source_norm, norms, the on-device
                    loop's t, n, dt_old and status, a run's final drain)

`TimerCollection` (the timers the plain steps are handed) opens and closes
spans of its timers' names; its `report()`, which the verbose
`Pyro.run_sim` prints, sums every span recorded since the collection was
made, by name under its parents.
"""

import collections
import contextlib
import time

import torch

__all__ = ["MAXLEN", "Span", "Timer", "TimerCollection", "read",
           "recording", "span", "spans"]

MAXLEN = 2 ** 16

Span = collections.namedtuple("Span", "name id parent step t0_ns t1_ns")

_buffer = collections.deque(maxlen=MAXLEN)
_open = []          # the spans open now, innermost last
_last_id = 0
_forced = 0         # depth of recording() blocks that record
_profiling = torch._C._autograd._profiler_enabled


class _Off:
    """The span of a call made while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def close(self):
        pass


_OFF = _Off()


class _Open:
    """A recorded span, open from its construction to close()."""

    __slots__ = ("name", "id", "parent", "step", "t0")

    def __init__(self, name, step):
        global _last_id
        _last_id += 1
        outer = _open[-1] if _open else None
        self.name, self.id = name, _last_id
        self.parent = outer.id if outer is not None else None
        if step is None and outer is not None:
            step = outer.step
        self.step = step
        _open.append(self)
        self.t0 = time.time_ns()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        t1 = time.time_ns()
        if _open and _open[-1] is self:
            _open.pop()
        elif self in _open:
            _open.remove(self)
        _buffer.append(Span(self.name, self.id, self.parent, self.step,
                            self.t0, t1))


def span(name, step=None):
    """A span named `name`, for a `with` block (or closed by `.close()`);
    `step` is set on a step's root span, and inherited otherwise."""
    if _forced or _profiling():
        return _Open(name, step)
    return _OFF


@contextlib.contextmanager
def recording(on=True):
    """Record spans inside the block even with no profiler session (when
    `on`)."""
    global _forced
    _forced += bool(on)
    try:
        yield
    finally:
        _forced -= bool(on)


def spans():
    """The recorded spans, oldest first (at most MAXLEN)."""
    return list(_buffer)


def read(x, what):
    """`x.tolist()`: the tensor's value on the host.  The host waits for
    every operation enqueued before it; the wait is a span `read:<what>`."""
    with span("read:" + what):
        return x.tolist()


class Timer:
    """A named timer: begin() opens a span of its name, end() closes the
    last one it opened."""

    def __init__(self, name):
        self.name = name
        self._spans = []

    def begin(self):
        self._spans.append(span(self.name))

    def end(self):
        if self._spans:
            self._spans.pop().close()


class TimerCollection:
    """Named timers over spans, and their report."""

    def __init__(self):
        self.timers = {}
        self.since = _last_id

    def timer(self, name):
        """Get (or create) the timer named `name`."""
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def report(self):
        """Print the seconds and the count of the spans recorded since the
        collection was made, summed by name under their parents (a span
        whose parent left the buffer counts as a root)."""
        mine = [s for s in _buffer if s.id > self.since]
        by_id = {s.id: s for s in mine}
        totals, first = {}, {}
        for s in mine:
            path, p = [s.name], by_id.get(s.parent)
            while p is not None:
                path.append(p.name)
                p = by_id.get(p.parent)
            path = tuple(reversed(path))
            seconds, count = totals.get(path, (0.0, 0))
            totals[path] = (seconds + (s.t1_ns - s.t0_ns) * 1e-9, count + 1)
            first[path] = min(first.get(path, s.t0_ns), s.t0_ns)
        # parents before their children, siblings in the order they began
        order = sorted(totals, key=lambda path: [
            first[path[:i + 1]] for i in range(len(path))])
        for path in order:
            seconds, count = totals[path]
            print(f"{'  ' * (len(path) - 1)}{path[-1]:20s}: "
                  f"{seconds:10.6f} s {count:8d}")
        if len(_buffer) == MAXLEN and mine and \
                min(s.id for s in mine) > self.since + 1:
            print(f"(only the newest {MAXLEN} spans are kept: older ones "
                  "are not counted)")
