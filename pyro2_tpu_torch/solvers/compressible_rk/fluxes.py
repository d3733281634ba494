"""MOL fluxes for compressible flow: plain PLM interface states (no
characteristic tracing), a single Riemann pass, artificial viscosity, and
the optional well-balanced hydrostatic pressure reconstruction
(`compressible.well_balanced`).

The port of pyro2_tpu/solvers/compressible_rk/fluxes.py.
"""

import torch

import pyro2_tpu_torch.solvers.compressible.unsplit_fluxes as ctu_flx
from pyro2_tpu_torch.mesh import reconstruction
from pyro2_tpu_torch.mesh.indexer import ai, embed
from pyro2_tpu_torch.solvers.compressible import riemann

__all__ = ["fluxes"]


def fluxes(U, my_data, rp, ivars, solid, tc, edges=(1, 1, 1, 1)):
    """(F_x, F_y) through all interfaces from one unsplit reconstruction.
    `edges` are the grid's domain-edge flags (xl, xr, yl, yr) of the
    artificial viscosity (compressible/simulation.py DomainEdges): all 1
    on a serial grid, 0 on a sharded block's seams."""
    from pyro2_tpu_torch.solvers.compressible import simulation as comp

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

    well_balanced = rp.get_param("compressible.well_balanced")
    grav = rp.get_param("compressible.grav")
    if well_balanced:
        # the hydrostatic-subtracted y slope of the pressure replaces the
        # flattened one (xi does not multiply it)
        ldy[ivars.ip] = reconstruction.well_balance(q, myg, limiter, ivars,
                                                    grav)

    b = 2
    qw = ai(q, myg).v(buf=b)
    ldx_w = ai(ldx, myg).v(buf=b)
    ldy_w = ai(ldy, myg).v(buf=b)

    V_xl = embed(qw + 0.5 * ldx_w, myg, buf=b, ishift=1)
    V_xr = embed(qw - 0.5 * ldx_w, myg, buf=b)
    V_yl_w = qw + 0.5 * ldy_w
    V_yr_w = qw - 0.5 * ldy_w
    if well_balanced:
        # p0 + p1 on the y faces: the hydrostatic p0 part added back
        p0_incr = 0.5 * myg.dy * qw[ivars.irho] * grav
        V_yl_w[ivars.ip] = qw[ivars.ip] + p0_incr + 0.5 * ldy_w[ivars.ip]
        V_yr_w[ivars.ip] = qw[ivars.ip] - p0_incr - 0.5 * ldy_w[ivars.ip]
    V_yl = embed(V_yl_w, myg, buf=b, jshift=1)
    V_yr = embed(V_yr_w, myg, buf=b)

    U_xl = comp.prim_to_cons(V_xl, gamma, ivars, myg)
    U_xr = comp.prim_to_cons(V_xr, gamma, ivars, myg)
    U_yl = comp.prim_to_cons(V_yl, gamma, ivars, myg)
    U_yr = comp.prim_to_cons(V_yr, gamma, ivars, myg)

    F_x = riemann.riemann_flux(1, U_xl, U_xr, my_data, rp, ivars,
                               solid.xl, solid.xr, tc)
    F_y = riemann.riemann_flux(2, U_yl, U_yr, my_data, rp, ivars,
                               solid.yl, solid.yr, tc)

    F_x, F_y = ctu_flx.apply_artificial_viscosity(F_x, F_y, q, U,
                                                  my_data, rp, ivars,
                                                  edges=edges)
    tm_flux.end()
    return F_x, F_y
