"""Nested named wall-clock timers (the port of pyro2_tpu/util/profile_pyro.py).

PyTorch returns from a CUDA call before the device has finished, so a timer
around device work measures the enqueue unless it synchronises first:
`Timer.end(sync=tensor)` synchronises the tensor's device before it reads
the clock.
"""

import time

import torch

__all__ = ["TimerCollection", "Timer"]


class Timer:
    """A single named accumulating timer."""

    def __init__(self, name, stack_count=0):
        self.name = name
        self.stack_count = stack_count
        self.is_running = False
        self.start_time = 0.0
        self.elapsed = 0.0

    def begin(self):
        self.start_time = time.perf_counter()
        self.is_running = True

    def end(self, sync=None):
        """Stop the timer; first wait for `sync`'s device if it is a GPU."""
        if isinstance(sync, torch.Tensor) and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        self.elapsed += time.perf_counter() - self.start_time
        self.is_running = False


class TimerCollection:
    """A collection of timers, nested by the order they were started."""

    def __init__(self):
        self.timers = {}
        self.order = []

    def timer(self, name):
        """Get (or create) the timer named `name`."""
        if name in self.timers:
            return self.timers[name]
        t = Timer(name, stack_count=self._stack_depth())
        self.timers[name] = t
        self.order.append(name)
        return t

    def _stack_depth(self):
        return sum(1 for t in self.timers.values() if t.is_running)

    def report(self):
        """Print all timers, indented by nesting depth."""
        for name in self.order:
            t = self.timers[name]
            print(f"{'  ' * t.stack_count}{name:20s}: {t.elapsed:10.6f} s")
