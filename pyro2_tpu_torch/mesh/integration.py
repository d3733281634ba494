"""Generic explicit Runge-Kutta integration via Butcher tableaux.

The port of pyro2_tpu/mesh/integration.py.  Stage starts and the final
update accumulate over the valid region only; the caller refills the
ghosts each stage.  Stage 0 starts from the start container itself, as in
the JAX package; every later stage starts from a clone, whose tensor is a
copy, so the in-place accumulation below never reaches the start's state
before the final update.
"""

import numpy as np

from pyro2_tpu_torch.mesh import patch

__all__ = ["a", "b", "c", "RKIntegrator"]

a = {
    "RK2": np.array([[0.0, 0.0], [0.5, 0.0]]),
    "TVD2": np.array([[0.0, 0.0], [1.0, 0.0]]),
    "TVD3": np.array([[0.0, 0.0, 0.0],
                      [1.0, 0.0, 0.0],
                      [0.25, 0.25, 0.0]]),
    "RK4": np.array([[0.0, 0.0, 0.0, 0.0],
                     [0.5, 0.0, 0.0, 0.0],
                     [0.0, 0.5, 0.0, 0.0],
                     [0.0, 0.0, 1.0, 0.0]]),
}

b = {
    "RK2": np.array([0.0, 1.0]),
    "TVD2": np.array([0.5, 0.5]),
    "TVD3": np.array([1. / 6., 1. / 6., 2. / 3.]),
    "RK4": np.array([1. / 6., 1. / 3., 1. / 3., 1. / 6.]),
}

c = {
    "RK2": np.array([0.0, 0.5]),
    "TVD2": np.array([0.0, 1.0]),
    "TVD3": np.array([0.0, 1.0, 0.5]),
    "RK4": np.array([0.0, 0.5, 0.5, 1.0]),
}


def _add_valid(stack, g, incr, coeff):
    """stack += coeff*incr over the valid region only, in place."""
    sl = (Ellipsis, slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
    stack[sl] += coeff * incr[sl]
    return stack


class RKIntegrator:
    """Explicit RK over CellCenterData2d state: set_start, then for each
    stage get_stage_start -> evaluate -> store_increment, finally
    compute_final_update."""

    def __init__(self, t, dt, method="RK4"):
        self.method = method
        self.t = t
        self.dt = dt
        self.k = [None] * len(b[self.method])
        self.start = None

    def nstages(self):
        return len(b[self.method])

    def set_start(self, start):
        """Store the starting CellCenterData2d."""
        self.start = start

    def store_increment(self, istage, k_stage):
        """Store stage istage's increment stack (no dt weighting)."""
        self.k[istage] = k_stage

    def get_stage_start(self, istage):
        """CellCenterData2d holding the stage-istage starting state."""
        if istage == 0:
            return self.start
        ytmp = patch.cell_center_data_clone(self.start)
        for s in range(istage):
            coeff = self.dt * a[self.method][istage, s]
            if coeff != 0.0:
                _add_valid(ytmp.data, ytmp.grid, self.k[s], coeff)
        ytmp.t = self.t + c[self.method][istage] * self.dt
        return ytmp

    def compute_final_update(self):
        """The t + dt update, written into the start container's state."""
        ytmp = self.start
        for s in range(self.nstages()):
            coeff = self.dt * b[self.method][s]
            if coeff != 0.0:
                _add_valid(ytmp.data, ytmp.grid, self.k[s], coeff)
        return ytmp

    def __str__(self):
        return (f"integration method: {self.method}; "
                f"number of stages: {self.nstages()}")
