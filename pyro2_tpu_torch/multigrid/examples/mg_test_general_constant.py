#!/usr/bin/env python3
"""General-form MG with constant coefficients reducing to plain Poisson.

alpha = 0, beta = 1, gamma = (0, 0), so alpha phi + div(beta grad phi) +
gamma.grad(phi) = f is just laplacian(phi) = f; exact
phi = (x**2 - x**4)(y**4 - y**2)
(the port of
pyro2_tpu/multigrid/examples/mg_test_general_constant.py)."""

import numpy as np

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.multigrid.examples import l2_error
from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d


def true(x, y):
    return (x ** 2 - x ** 4) * (y ** 4 - y ** 2)


def f(x, y):
    return -2.0 * ((1.0 - 6.0 * x ** 2) * y ** 2 * (1.0 - y ** 2) +
                   (1.0 - 6.0 * y ** 2) * x ** 2 * (1.0 - x ** 2))


def test_general_poisson_constant(N, *, verbose=0, rtol=1.e-11,
                                  device=None, dtype=None):
    """Solve at resolution N; returns the L2 error vs the true solution."""
    g = Grid2d(N, N, ng=1)
    d = patch.CellCenterData2d(g, device=device, dtype=dtype)
    bc_c = bnd.BC(xlb="neumann", xrb="neumann",
                  ylb="neumann", yrb="neumann")
    for name in ["alpha", "beta", "gamma_x", "gamma_y"]:
        d.register_var(name, bc_c)
    d.create()
    d.set_var("alpha", np.zeros((g.qx, g.qy)))
    d.set_var("beta", np.ones((g.qx, g.qy)))
    d.set_var("gamma_x", np.zeros((g.qx, g.qy)))
    d.set_var("gamma_y", np.zeros((g.qx, g.qy)))

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
        test_general_poisson_constant(n)
