#!/usr/bin/env python3
"""General-form MG with all three terms active, Dirichlet BCs.

alpha = 1, beta = 2 + cos(2 pi x) cos(2 pi y),
gamma = (sin(2 pi x), sin(2 pi y)); exact phi = sin(2 pi x) sin(2 pi y)
(the port of
pyro2_tpu/multigrid/examples/mg_test_general_dirichlet.py)."""

import numpy as np

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.multigrid.examples import l2_error
from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d


def true(x, y):
    return np.sin(2.0 * np.pi * x) * np.sin(2.0 * np.pi * y)


def beta(x, y):
    return 2.0 + np.cos(2.0 * np.pi * x) * np.cos(2.0 * np.pi * y)


def f(x, y):
    return ((-16.0 * np.pi ** 2 * np.cos(2 * np.pi * x) *
             np.cos(2 * np.pi * y) +
             2.0 * np.pi * np.cos(2 * np.pi * x) +
             2.0 * np.pi * np.cos(2 * np.pi * y) -
             16.0 * np.pi ** 2 + 1.0) *
            np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y))


def test_general_poisson_dirichlet(N, *, verbose=0, rtol=1.e-11,
                                   device=None, dtype=None):
    """Solve at resolution N; returns the L2 error vs the true solution."""
    g = Grid2d(N, N, ng=1)
    d = patch.CellCenterData2d(g, device=device, dtype=dtype)
    bc_c = bnd.BC(xlb="neumann", xrb="neumann",
                  ylb="neumann", yrb="neumann")
    for name in ["alpha", "beta", "gamma_x", "gamma_y"]:
        d.register_var(name, bc_c)
    d.create()
    d.set_var("alpha", np.ones((g.qx, g.qy)))
    d.set_var("beta", beta(g.x2d, g.y2d))
    d.set_var("gamma_x", np.sin(2.0 * np.pi * g.x2d))
    d.set_var("gamma_y", np.sin(2.0 * np.pi * g.y2d))

    a = GeneralMG2d(N, N,
                    xl_BC_type="dirichlet", yl_BC_type="dirichlet",
                    xr_BC_type="dirichlet", yr_BC_type="dirichlet",
                    coeffs=d, verbose=verbose, device=device,
                    dtype=dtype)
    a.init_zeros()
    a.init_RHS(f(a.x2d, a.y2d))
    a.solve(rtol=rtol)

    enorm = l2_error(a, a.get_solution(), true(a.x2d, a.y2d))
    print(f"N = {N}: L2 error from true solution = {enorm:g} "
          f"(cycles = {a.num_cycles})")
    return enorm


if __name__ == "__main__":
    for n in (16, 32, 64, 128):
        test_general_poisson_dirichlet(n)
