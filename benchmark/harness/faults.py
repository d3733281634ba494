"""Faults planted in the program under the harness, for the tests and the
chip readings that show the comparison catches them (benchmark/control.py,
benchmark/tests/).  The benchmark's own runs plant none.

  unchanged  every step returns its state unchanged;
  altered    every step's output has one interior zone of its first
             variable 1% off, where the step produces it.

A solver with a kernel-backed `_step` (the CTU solver, on either loop:
the chunk runner takes `_step` when it is built) is broken there;
another (diffusion) around its `evolve`.
"""

__all__ = ["KINDS", "plant"]

KINDS = ("unchanged", "altered")


def _alter(U):
    U = U.clone()
    i, j = U.shape[-2] // 2, U.shape[-1] // 3
    U[0, i, j] = U[0, i, j] * 1.01
    return U


def plant(sim, kind):
    """Break sim's steps with the fault `kind`."""
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}")
    step = getattr(sim, "_step", None)
    if step is not None:
        if kind == "unchanged":
            sim._step = lambda U, t, dt: U.clone()
        else:
            sim._step = lambda U, t, dt: _alter(step(U, t, dt))
        return
    evolve = sim.evolve

    def broken():
        before = sim.cc_data.data.clone()
        evolve()
        after = before if kind == "unchanged" else \
            _alter(sim.cc_data.data)
        sim.cc_data.data.copy_(after)

    sim.evolve = broken
