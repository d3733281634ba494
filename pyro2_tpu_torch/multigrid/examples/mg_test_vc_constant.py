#!/usr/bin/env python3
"""Variable-coefficient MG with constant coefficient = plain Poisson.

div(alpha grad phi) = f with alpha = 1 everywhere; exact
phi = (x**2 - x**4)(y**4 - y**2).  Checks that the variable-coefficient
machinery (edge-averaged coefficients, coefficient restriction) reduces
exactly to the constant-coefficient operator
(the port of pyro2_tpu/multigrid/examples/mg_test_vc_constant.py)."""

import numpy as np

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.multigrid.examples import l2_error
from pyro2_tpu_torch.multigrid.variable_coeff_MG import VarCoeffCCMG2d


def true(x, y):
    return (x ** 2 - x ** 4) * (y ** 4 - y ** 2)


def f(x, y):
    return -2.0 * ((1.0 - 6.0 * x ** 2) * y ** 2 * (1.0 - y ** 2) +
                   (1.0 - 6.0 * y ** 2) * x ** 2 * (1.0 - x ** 2))


def test_vc_poisson_constant(N, *, verbose=0, rtol=1.e-11, device=None,
                             dtype=None):
    """Solve at resolution N; returns the L2 error vs the true solution."""
    g = Grid2d(N, N, ng=1)
    # alpha's BCs differ from phi's: a homogeneous Dirichlet coefficient
    # would zero alpha on the interfaces, so use Neumann for the coeffs
    bc_c = bnd.BC(xlb="neumann", xrb="neumann",
                  ylb="neumann", yrb="neumann")

    a = VarCoeffCCMG2d(N, N,
                       xl_BC_type="dirichlet", yl_BC_type="dirichlet",
                       xr_BC_type="dirichlet", yr_BC_type="dirichlet",
                       coeffs=np.ones((g.qx, g.qy)), coeffs_bc=bc_c,
                       verbose=verbose, device=device, dtype=dtype)
    a.init_zeros()
    a.init_RHS(f(a.x2d, a.y2d))
    a.solve(rtol=rtol)

    enorm = l2_error(a, a.get_solution(), true(a.x2d, a.y2d))
    print(f"N = {N}: L2 error from true solution = {enorm:g} "
          f"(cycles = {a.num_cycles})")
    return enorm


if __name__ == "__main__":
    for n in (16, 32, 64, 128):
        test_vc_poisson_constant(n)
