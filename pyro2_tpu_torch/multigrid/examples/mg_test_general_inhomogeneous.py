#!/usr/bin/env python3
"""General-form elliptic solve with inhomogeneous BCs.

alpha phi + div(beta grad phi) + gamma.grad(phi) = f with alpha = 10,
beta = xy + 1, gamma = (1, 1); exact phi = cos(pi x/2) cos(pi y/2)
(the port of
pyro2_tpu/multigrid/examples/mg_test_general_inhomogeneous.py)."""

import numpy as np

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.multigrid.examples import l2_error
from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d


def true(x, y):
    return np.cos(np.pi * x / 2.0) * np.cos(np.pi * y / 2.0)


def f(x, y):
    return (-0.5 * np.pi * (x + 1.0) * np.sin(np.pi * y / 2.0) *
            np.cos(np.pi * x / 2.0) -
            0.5 * np.pi * (y + 1.0) * np.sin(np.pi * x / 2.0) *
            np.cos(np.pi * y / 2.0) +
            (-np.pi ** 2 * (x * y + 1.0) / 2.0 + 10.0) *
            np.cos(np.pi * x / 2.0) * np.cos(np.pi * y / 2.0))


def test_general_poisson_inhomogeneous(N, *, verbose=0, rtol=1.e-11,
                                       device=None, dtype=None):
    """Solve at resolution N; returns the L2 error vs the true solution."""
    g = Grid2d(N, N, ng=1)
    d = patch.CellCenterData2d(g, device=device, dtype=dtype)
    bc_c = bnd.BC(xlb="neumann", xrb="neumann",
                  ylb="neumann", yrb="neumann")
    for name in ["alpha", "beta", "gamma_x", "gamma_y"]:
        d.register_var(name, bc_c)
    d.create()
    d.set_var("alpha", np.full((g.qx, g.qy), 10.0))
    d.set_var("beta", g.x2d * g.y2d + 1.0)
    d.set_var("gamma_x", np.ones((g.qx, g.qy)))
    d.set_var("gamma_y", np.ones((g.qx, g.qy)))

    a = GeneralMG2d(N, N,
                    xl_BC_type="dirichlet", yl_BC_type="dirichlet",
                    xr_BC_type="dirichlet", yr_BC_type="dirichlet",
                    xl_BC=lambda y: np.cos(np.pi * y / 2.0),
                    yl_BC=lambda x: np.cos(np.pi * x / 2.0),
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
        test_general_poisson_inhomogeneous(n)
