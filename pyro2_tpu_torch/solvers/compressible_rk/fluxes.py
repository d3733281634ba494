"""MOL fluxes for compressible flow: plain PLM interface states (no
characteristic tracing), a single Riemann pass and artificial viscosity.

The port of pyro2_tpu/solvers/compressible_rk/fluxes.py.  The
well-balanced hydrostatic reconstruction (`compressible.well_balanced`)
waits for `reconstruction.well_balance` (ROADMAP.md A.9) and
raises.
"""

import torch

import pyro2_tpu_torch.solvers.compressible.unsplit_fluxes as ctu_flx
from pyro2_tpu_torch.mesh import reconstruction
from pyro2_tpu_torch.mesh.indexer import ai, embed
from pyro2_tpu_torch.solvers.compressible import riemann

__all__ = ["fluxes", "uncovered_well_balanced"]


def uncovered_well_balanced():
    return NotImplementedError(
        "compressible.well_balanced waits for reconstruction.well_balance "
        "(ROADMAP.md A.9)")


def fluxes(U, my_data, rp, ivars, solid, tc):
    """(F_x, F_y) through all interfaces from one unsplit reconstruction."""
    from pyro2_tpu_torch.solvers.compressible import simulation as comp

    if rp.get_param("compressible.well_balanced"):
        raise uncovered_well_balanced()

    tm_flux = tc.timer("unsplitFluxes")
    tm_flux.begin()

    myg = my_data.grid
    gamma = rp.get_param("eos.gamma")

    q = comp.cons_to_prim(U, gamma, ivars, myg, check=False)

    if rp.get_param("compressible.use_flattening"):
        xi_x = reconstruction.flatten(myg, q, 1, ivars, rp)
        xi_y = reconstruction.flatten(myg, q, 2, ivars, rp)
        xi = reconstruction.flatten_multid(myg, q, xi_x, xi_y, ivars)
    else:
        xi = 1.0

    limiter = rp.get_param("compressible.limiter")
    ldx = torch.stack([xi * reconstruction.limit(q[n], myg, 1, limiter)
                       for n in range(ivars.nq)])
    ldy = torch.stack([xi * reconstruction.limit(q[n], myg, 2, limiter)
                       for n in range(ivars.nq)])

    b = 2
    qw = ai(q, myg).v(buf=b)
    ldx_w = ai(ldx, myg).v(buf=b)
    ldy_w = ai(ldy, myg).v(buf=b)

    V_xl = embed(qw + 0.5 * ldx_w, myg, buf=b, ishift=1)
    V_xr = embed(qw - 0.5 * ldx_w, myg, buf=b)
    V_yl = embed(qw + 0.5 * ldy_w, myg, buf=b, jshift=1)
    V_yr = embed(qw - 0.5 * ldy_w, myg, buf=b)

    U_xl = comp.prim_to_cons(V_xl, gamma, ivars, myg)
    U_xr = comp.prim_to_cons(V_xr, gamma, ivars, myg)
    U_yl = comp.prim_to_cons(V_yl, gamma, ivars, myg)
    U_yr = comp.prim_to_cons(V_yr, gamma, ivars, myg)

    F_x = riemann.riemann_flux(1, U_xl, U_xr, my_data, rp, ivars,
                               solid.xl, solid.xr, tc)
    F_y = riemann.riemann_flux(2, U_yl, U_yr, my_data, rp, ivars,
                               solid.yl, solid.yr, tc)

    F_x, F_y = ctu_flx.apply_artificial_viscosity(F_x, F_y, q, U,
                                                  my_data, rp, ivars)
    tm_flux.end()
    return F_x, F_y
