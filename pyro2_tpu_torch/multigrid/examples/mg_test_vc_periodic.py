#!/usr/bin/env python3
"""Variable-coefficient Poisson with periodic BCs (same problem as the
Dirichlet variant; the solution is defined up to a constant)
(the port of pyro2_tpu/multigrid/examples/mg_test_vc_periodic.py)."""

import numpy as np

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.multigrid.examples.mg_test_vc_dirichlet import (alpha,
                                                                      f,
                                                                      true)
from pyro2_tpu_torch.multigrid.variable_coeff_MG import VarCoeffCCMG2d


def test_vc_poisson_periodic(N, *, verbose=0, rtol=1.e-11, device=None,
                             dtype=None):
    """Solve at resolution N; returns the (demeaned) L2 error."""
    g = Grid2d(N, N, ng=1)
    bc_c = bnd.BC(xlb="periodic", xrb="periodic",
                  ylb="periodic", yrb="periodic")

    a = VarCoeffCCMG2d(N, N,
                       xl_BC_type="periodic", yl_BC_type="periodic",
                       xr_BC_type="periodic", yr_BC_type="periodic",
                       coeffs=alpha(g.x2d, g.y2d), coeffs_bc=bc_c,
                       verbose=verbose, device=device, dtype=dtype)
    a.init_zeros()
    a.init_RHS(f(a.x2d, a.y2d))
    a.solve(rtol=rtol)

    v = ai(a.get_solution(), a.soln_grid).v().cpu().numpy()
    t = true(a.x2d, a.y2d)[a.ilo:a.ihi + 1, a.jlo:a.jhi + 1]
    e = (v - v.mean()) - (t - t.mean())
    enorm = float(np.sqrt(a.dx * a.dy * np.sum(e ** 2)))
    print(f"N = {N}: (demeaned) L2 error from true solution = {enorm:g} "
          f"(cycles = {a.num_cycles})")
    return enorm


if __name__ == "__main__":
    for n in (16, 32, 64, 128):
        test_vc_poisson_periodic(n)
