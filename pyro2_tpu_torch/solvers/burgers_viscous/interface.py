"""Viscous-Burgers helpers: the 5-point Laplacian, the diffusion-corrected
interface states, and the Crank-Nicolson + advective-source Helmholtz
solve (the port of pyro2_tpu/solvers/burgers_viscous/interface.py).

No function writes its inputs.  `diffuse` solves on the constant
multigrid on the state's device and dtype, so on CUDA each of its
V-cycles runs the multigrid kernels (mg_core, mg_down, mg_up).
"""

import torch

from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.multigrid import MG
from pyro2_tpu_torch.solvers.burgers.burgers_interface import _add

__all__ = ["get_lap", "diffuse", "apply_diffusion_corrections"]


def get_lap(g, a):
    """Full padded array holding the 5-point Laplacian on buf=2."""
    av = ai(a, g)
    lap = torch.zeros_like(a)
    lap[g.ilo - 2:g.ihi + 3, g.jlo - 2:g.jhi + 3] = \
        (av.ip(1, buf=2) - 2.0 * av.v(buf=2) + av.ip(-1, buf=2)) / \
        g.dx ** 2 + \
        (av.jp(1, buf=2) - 2.0 * av.v(buf=2) + av.jp(-1, buf=2)) / g.dy ** 2
    return lap


def diffuse(my_data, rp, dt, scalar_name, A):
    """C-N solve of (1 - dt/2 eps L) a = a + dt/2 eps L a - dt A.

    Returns the updated full padded array for scalar_name (the state is
    not written)."""
    myg = my_data.grid
    a = my_data.get_var(scalar_name)
    eps = rp.get_param("diffusion.eps")
    bcs = my_data.BCs[scalar_name]

    mg = MG.CellCenterMG2d(myg.nx, myg.ny,
                           xmin=myg.xmin, xmax=myg.xmax,
                           ymin=myg.ymin, ymax=myg.ymax,
                           xl_BC_type=bcs.xlb, xr_BC_type=bcs.xrb,
                           yl_BC_type=bcs.ylb, yr_BC_type=bcs.yrb,
                           alpha=1.0, beta=0.5 * dt * eps, verbose=0,
                           device=my_data.device, dtype=my_data.dtype)

    lap = get_lap(myg, a)
    f = mg.soln_grid.scratch_array(dtype=my_data.dtype,
                                   device=my_data.device)
    f[mg.ilo:mg.ihi + 1, mg.jlo:mg.jhi + 1] = \
        ai(a, myg).v() + 0.5 * dt * eps * ai(lap, myg).v() - \
        dt * ai(A, myg).v()

    mg.init_RHS(f)
    mg.init_zeros()
    mg.solve(rtol=1.e-12)

    sol = mg.get_solution()
    out = a.clone()
    out[myg.ilo:myg.ihi + 1, myg.jlo:myg.jhi + 1] = \
        ai(sol, mg.soln_grid).v()
    return out


def apply_diffusion_corrections(g, dt, eps, u, v,
                                u_xl, u_xr, u_yl, u_yr,
                                v_xl, v_xr, v_yl, v_yr):
    """Add 0.5*eps*dt*Lap(U) to all interface states (new tensors)."""
    cu = 0.5 * eps * dt * ai(get_lap(g, u), g).v(buf=2)
    cv = 0.5 * eps * dt * ai(get_lap(g, v), g).v(buf=2)

    u_xl = _add(u_xl, g, cu, ishift=1)
    u_yl = _add(u_yl, g, cu, jshift=1)
    u_xr = _add(u_xr, g, cu)
    u_yr = _add(u_yr, g, cu)
    v_xl = _add(v_xl, g, cv, ishift=1)
    v_yl = _add(v_yl, g, cv, jshift=1)
    v_xr = _add(v_xr, g, cv)
    v_yr = _add(v_yr, g, cv)
    return u_xl, u_xr, u_yl, u_yr, v_xl, v_xr, v_yl, v_yr
