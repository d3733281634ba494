"""Compressible-specific extended boundary conditions.

The port of pyro2_tpu/solvers/compressible/BC.py: "hse" (hydrostatic
pressure integration into ghosts, constant density), "ambient" (fill from
the stored ambient state), and "ramp" (time-dependent oblique-shock inflow
for the double Mach reflection problem).

Contract (see pyro2_tpu_torch.mesh.boundary.define_bc): the function fills
the ghosts of one variable of the full state stack in place and returns
the stack.

The ramp's fills run on the device alone: its shock front is computed from
the container's t -- a float on the host loop, the 0-d tensor that
fill_bc_stack(U, t) is given on the on-device loop -- in the state's dtype,
over geometry copied to the device once per grid, dtype and device
(`ramp_geometry`), so a fill reads nothing from the host and a captured
CUDA graph replays it with the t it carries.  In float64 the two give the
same bits, which are those of the numpy arithmetic the JAX package's fill
does on the host.
"""

import math

import numpy as np
import torch

from pyro2_tpu_torch.solvers.compressible import eos
from pyro2_tpu_torch.util import msg

_SRC_LIKE = ["density", "x-momentum", "y-momentum",
             "dens_src", "xmom_src", "ymom_src", "E_src", "fuel", "ash"]


def _hse_energy(stack, ccdata, v, j_base, sign):
    """Integrate dP = -rho g dy from row j_base into the ng ghost rows on
    one side (sign -1 below, +1 above) at constant density."""
    myg = ccdata.grid
    dens = stack[ccdata.names.index("density")]
    xmom = stack[ccdata.names.index("x-momentum")]
    ymom = stack[ccdata.names.index("y-momentum")]

    grav = ccdata.get_aux("grav")
    gamma = ccdata.get_aux("gamma")

    dens_base = dens[:, j_base]
    ke_base = 0.5 * (xmom[:, j_base] ** 2 +
                     ymom[:, j_base] ** 2) / dens_base
    eint_base = (v[:, j_base] - ke_base) / dens_base
    pres_base = eos.pres(gamma, dens_base, eint_base)

    for k in range(1, myg.ng + 1):
        if sign < 0:
            pres_k = pres_base - k * grav * dens_base * myg.dy
        else:
            pres_k = pres_base + k * grav * dens_base * myg.dy
        v[:, j_base + sign * k] = eos.rhoe(gamma, pres_k) + ke_base


# the shock's angle and the speed of its front along the top edge
_TAN60 = math.tan(math.pi / 3.0)
_FRONT_SPEED = 10.0 / math.sin(math.pi / 3.0)


def ramp_geometry(myg, like):
    """(cx, offset, inflow) of the ramp's fills on `like`'s device in its
    dtype, made once per grid, dtype and device: cx (2, qx), the two
    abscissae of each cell's 4-point quadrature; offset (ng, 2), the front's
    abscissa at t = 0 at the lower and upper quadrature ordinate of each
    top ghost row (the front at t is offset + _FRONT_SPEED * t, evaluated
    in that order as the host's double arithmetic does); inflow (qx,),
    x < 1/6, where the bottom edge takes the post-shock state."""
    key = (like.dtype, like.device)
    cache = myg.__dict__.setdefault("_ramp_geometry", {})
    if key not in cache:
        half_x = 0.5 * myg.dx * math.sqrt(3)
        half_y = 0.5 * myg.dy * math.sqrt(3)
        cx = np.stack([myg.x - half_x, myg.x + half_x])
        offset = np.asarray(
            [[1.0 / 6.0 + (myg.y[j] - half_y) / _TAN60,
              1.0 / 6.0 + (myg.y[j] + half_y) / _TAN60]
             for j in range(myg.jhi + 1, myg.jhi + myg.ng + 1)])
        as_like = {"dtype": like.dtype, "device": like.device}
        cache[key] = (torch.as_tensor(cx, **as_like),
                      torch.as_tensor(offset, **as_like),
                      torch.as_tensor(myg.x < 1.0 / 6.0, device=like.device))
    return cache[key]


def ramp_top_rows(myg, t, post, pre, like):
    """The top ghost rows (qx, ng) of one variable under the moving front
    at t (a float or a 0-d tensor): each cell blends the post- and
    pre-shock values by the 4-point (2 front positions x 2 cell extents)
    quadrature, summed in the host's order."""
    cx, offset, _ = ramp_geometry(myg, like)
    sf = offset + _FRONT_SPEED * t                             # (ng, 2)
    below = cx[None, None, :, :] < sf[:, :, None, None]   # (ng, 2, 2, qx)
    w = torch.where(below, like.new_full((), 0.25 * post), 0.25 * pre)
    rows = ((w[:, 0, 0] + w[:, 0, 1]) + w[:, 1, 0]) + w[:, 1, 1]
    return rows.T


def user(bc_name, bc_edge, variable, ccdata, stack):
    """Fill the named extended BC in place; returns the stack."""
    myg = ccdata.grid
    n = ccdata.names.index(variable)
    v = stack[n]

    if bc_name == "hse":
        if bc_edge == "ylb":
            if variable in _SRC_LIKE:
                # constant into the ghosts
                v[:, 0:myg.jlo] = v[:, myg.jlo:myg.jlo + 1]
            elif variable == "energy":
                _hse_energy(stack, ccdata, v, myg.jlo, -1)
            else:
                raise NotImplementedError("variable not defined")

        elif bc_edge == "yrb":
            if variable in _SRC_LIKE:
                v[:, myg.jhi + 1:] = v[:, myg.jhi:myg.jhi + 1]
            elif variable == "energy":
                _hse_energy(stack, ccdata, v, myg.jhi, +1)
            else:
                raise NotImplementedError("variable not defined")
        else:
            msg.fail("error: hse BC not supported for xlb or xrb")

    elif bc_name == "ambient":
        ambient_rho = ccdata.get_aux("ambient_rho")
        ambient_u = ccdata.get_aux("ambient_u")
        ambient_v = ccdata.get_aux("ambient_v")
        ambient_p = ccdata.get_aux("ambient_p")

        if bc_edge == "yrb":
            # zero-gradient default, overwritten by the ambient state
            v[:, myg.jhi + 1:] = v[:, myg.jhi:myg.jhi + 1]
            ghost = slice(myg.jhi + 1, myg.jhi + myg.ng + 1)
            if variable == "density":
                v[:, ghost] = ambient_rho
            elif variable == "x-momentum":
                v[:, ghost] = ambient_rho * ambient_u
            elif variable == "y-momentum":
                v[:, ghost] = ambient_rho * ambient_v
            elif variable == "energy":
                gamma = ccdata.get_aux("gamma")
                ke = 0.5 * ambient_rho * (ambient_u ** 2 + ambient_v ** 2)
                v[:, ghost] = ambient_p / (gamma - 1.0) + ke
        else:
            msg.fail("error: ambient BC not supported for xlb, xrb, or ylb")

    elif bc_name == "ramp":
        gamma = ccdata.get_aux("gamma")
        cons_vars = ["density", "x-momentum", "y-momentum", "energy"]

        if bc_edge == "xrb":
            pass
        elif variable not in cons_vars:
            v.zero_()  # no source term
        elif bc_edge == "xlb":
            v[0:myg.ilo, :] = inflow_post_bc(variable, gamma)

        elif bc_edge == "ylb":
            post = inflow_post_bc(variable, gamma)
            xcen_l = ramp_geometry(myg, v)[2]
            sgn = -1.0 if variable == "y-momentum" else 1.0
            for k in range(myg.ng):
                refl = sgn * v[:, myg.jlo + k]
                v[:, myg.jlo - 1 - k] = torch.where(xcen_l, post, refl)

        elif bc_edge == "yrb":
            # the Mach-10 oblique shock front sweeps along the top
            # boundary
            v[:, myg.jhi + 1:myg.jhi + myg.ng + 1] = ramp_top_rows(
                myg, ccdata.t, inflow_post_bc(variable, gamma),
                inflow_pre_bc(variable, gamma), v)
    else:
        msg.fail(f"error: bc type {bc_name} not supported")

    return stack


def inflow_post_bc(var, g):
    """The post-shock (inflow) state for the double Mach reflection."""
    r_l = 8.0
    u_l = 7.1447096
    v_l = -4.125
    p_l = 116.5
    if var == "density":
        return r_l
    if var == "x-momentum":
        return r_l * u_l
    if var == "y-momentum":
        return r_l * v_l
    if var == "energy":
        return p_l / (g - 1.0) + 0.5 * r_l * (u_l * u_l + v_l * v_l)
    return 0.0


def inflow_pre_bc(var, g):
    """The undisturbed pre-shock state for the double Mach reflection."""
    r_r = 1.4
    u_r = 0.0
    v_r = 0.0
    p_r = 1.0
    if var == "density":
        return r_r
    if var == "x-momentum":
        return r_r * u_r
    if var == "y-momentum":
        return r_r * v_r
    if var == "energy":
        return p_r / (g - 1.0) + 0.5 * r_r * (u_r * u_r + v_r * v_r)
    return 0.0
