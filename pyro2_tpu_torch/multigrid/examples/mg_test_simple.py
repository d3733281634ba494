#!/usr/bin/env python3
"""Constant-coefficient Poisson with Dirichlet BCs.

Solves u_xx + u_yy = -2[(1-6x^2)y^2(1-y^2) + (1-6y^2)x^2(1-x^2)], u=0 on
the boundary; exact u = (x^2-x^4)(y^4-y^2) (A Multigrid Tutorial, p.64;
the port of pyro2_tpu/multigrid/examples/mg_test_simple.py)."""


from pyro2_tpu_torch.multigrid import MG
from pyro2_tpu_torch.multigrid.examples import l2_error


def true(x, y):
    return (x ** 2 - x ** 4) * (y ** 4 - y ** 2)


def f(x, y):
    return -2.0 * ((1.0 - 6.0 * x ** 2) * y ** 2 * (1.0 - y ** 2) +
                   (1.0 - 6.0 * y ** 2) * x ** 2 * (1.0 - x ** 2))


def test_poisson_dirichlet(N, *, verbose=0, rtol=1.e-11, device=None,
                           dtype=None):
    """Solve at resolution N; returns the L2 error vs the true solution."""
    a = MG.CellCenterMG2d(N, N,
                          xl_BC_type="dirichlet", yl_BC_type="dirichlet",
                          xr_BC_type="dirichlet", yr_BC_type="dirichlet",
                          verbose=verbose, device=device, dtype=dtype)
    a.init_zeros()
    a.init_RHS(f(a.x2d, a.y2d))
    a.solve(rtol=rtol)

    enorm = l2_error(a, a.get_solution(), true(a.x2d, a.y2d))
    print(f"N = {N}: L2 error from true solution = {enorm:g} "
          f"(cycles = {a.num_cycles}, residual = {a.residual_error:g})")
    return enorm


if __name__ == "__main__":
    for n in (16, 32, 64, 128, 256):
        test_poisson_dirichlet(n)
