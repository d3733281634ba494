"""Unsplit CTU fluxes for the shallow water equations.

The port of pyro2_tpu/solvers/swe/unsplit_fluxes.py: tracing -> first
Riemann pass for transverse fluxes -> transverse-corrected interface
states -> second Riemann pass for the final fluxes.  No flattening and no
artificial viscosity: the JAX swe path applies neither (`swe.cvisc` is
read by nothing).
"""

import torch

import pyro2_tpu_torch.solvers.swe.interface as ifc
from pyro2_tpu_torch.mesh import reconstruction
from pyro2_tpu_torch.mesh.indexer import ai, embed
from pyro2_tpu_torch.util import msg

__all__ = ["unsplit_fluxes", "transverse_corrections", "check_flattening",
           "SWE_ITEM"]

SWE_ITEM = "A.8: swe"


def check_flattening(rp):
    """Raise for swe.use_flattening = 1, which the JAX package cannot run
    either: its flattening reads a pressure, and swe has none."""
    if rp.get_param("swe.use_flattening"):
        raise NotImplementedError(
            "swe.use_flattening = 1 is not supported: flattening reads a "
            f"pressure that swe does not have (ROADMAP.md, {SWE_ITEM})")


def unsplit_fluxes(U, my_data, rp, ivars, solid, tc, dt):
    """Construct the x and y interface fluxes (two Riemann passes)."""
    from pyro2_tpu_torch.solvers.swe import simulation as swe

    check_flattening(rp)
    tm_flux = tc.timer("unsplitFluxes")
    tm_flux.begin()

    myg = my_data.grid
    grav = rp.get_param("swe.grav")

    q = swe.cons_to_prim(U, ivars, myg)

    limiter = rp.get_param("swe.limiter")
    ldx = torch.stack([reconstruction.limit(q[n], myg, 1, limiter)
                       for n in range(ivars.nq)])
    ldy = torch.stack([reconstruction.limit(q[n], myg, 2, limiter)
                       for n in range(ivars.nq)])

    V_xl, V_xr = ifc.states(1, myg, myg.dx, dt, ivars, grav, q, ldx)
    V_yl, V_yr = ifc.states(2, myg, myg.dy, dt, ivars, grav, q, ldy)

    U_xl = swe.prim_to_cons(V_xl, ivars, myg)
    U_xr = swe.prim_to_cons(V_xr, ivars, myg)
    U_yl = swe.prim_to_cons(V_yl, ivars, myg)
    U_yr = swe.prim_to_cons(V_yr, ivars, myg)

    riemann = rp.get_param("swe.riemann")
    if riemann == "HLLC":
        riemannFunc = ifc.riemann_hllc
    elif riemann == "Roe":
        riemannFunc = ifc.riemann_roe
    else:
        msg.fail("ERROR: Riemann solver undefined")

    # first pass: transverse fluxes
    F_x = riemannFunc(1, myg, ivars, solid.xl, solid.xr, grav, U_xl, U_xr)
    F_y = riemannFunc(2, myg, ivars, solid.yl, solid.yr, grav, U_yl, U_yr)

    U_xl, U_xr, U_yl, U_yr = transverse_corrections(
        U_xl, U_xr, U_yl, U_yr, F_x, F_y, myg, dt)

    # second pass: the final normal fluxes
    F_x = riemannFunc(1, myg, ivars, solid.xl, solid.xr, grav, U_xl, U_xr)
    F_y = riemannFunc(2, myg, ivars, solid.yl, solid.yr, grav, U_yl, U_yr)

    tm_flux.end()
    return F_x, F_y


def transverse_corrections(U_xl, U_xr, U_yl, U_yr, F_x, F_y, myg, dt):
    """The interface states with the first pass's transverse flux
    differences added, on the window b = (2, 1): lo 2 and hi 1 on BOTH axes
    (indexer._buf_split), for the x and the y states alike."""
    b = (2, 1)
    Fx = ai(F_x, myg)
    Fy = ai(F_y, myg)
    dtdx = dt / myg.dx
    dtdy = dt / myg.dy

    U_xl = U_xl + embed(-0.5 * dtdy * (Fy.ip_jp(-1, 1, buf=b) -
                                       Fy.ip(-1, buf=b)), myg, b)
    U_xr = U_xr + embed(-0.5 * dtdy * (Fy.jp(1, buf=b) - Fy.v(buf=b)),
                        myg, b)
    U_yl = U_yl + embed(-0.5 * dtdx * (Fx.ip_jp(1, -1, buf=b) -
                                       Fx.jp(-1, buf=b)), myg, b)
    U_yr = U_yr + embed(-0.5 * dtdx * (Fx.ip(1, buf=b) - Fx.v(buf=b)),
                        myg, b)
    return U_xl, U_xr, U_yl, U_yr
