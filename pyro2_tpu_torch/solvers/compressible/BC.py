"""Compressible-specific extended boundary conditions.

The port of pyro2_tpu/solvers/compressible/BC.py: "hse" (hydrostatic
pressure integration into ghosts, constant density), "ambient" (fill from
the stored ambient state), and "ramp" (time-dependent oblique-shock inflow
for the double Mach reflection problem).

Contract (see pyro2_tpu_torch.mesh.boundary.define_bc): the function fills
the ghosts of one variable of the full state stack in place and returns
the stack.
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
            xcen_l = torch.as_tensor(myg.x < 1.0 / 6.0, device=v.device)
            sgn = -1.0 if variable == "y-momentum" else 1.0
            for k in range(myg.ng):
                refl = sgn * v[:, myg.jlo + k]
                v[:, myg.jlo - 1 - k] = torch.where(xcen_l, post, refl)

        elif bc_edge == "yrb":
            # the Mach-10 oblique shock front sweeps along the top
            # boundary; each ghost cell blends pre/post-shock states by
            # the 4-point (2 front positions x 2 cell extents) quadrature
            post = inflow_post_bc(variable, gamma)
            pre = inflow_pre_bc(variable, gamma)
            t = ccdata.t
            cx = np.stack([myg.x - 0.5 * myg.dx * math.sqrt(3),
                           myg.x + 0.5 * myg.dx * math.sqrt(3)])  # (2, qx)
            for j in range(myg.jhi + 1, myg.jhi + myg.ng + 1):
                sf_up = (1.0 / 6.0 +
                         (myg.y[j] + 0.5 * myg.dy * math.sqrt(3)) /
                         math.tan(math.pi / 3.0) +
                         (10.0 / math.sin(math.pi / 3.0)) * t)
                sf_down = (1.0 / 6.0 +
                           (myg.y[j] - 0.5 * myg.dy * math.sqrt(3)) /
                           math.tan(math.pi / 3.0) +
                           (10.0 / math.sin(math.pi / 3.0)) * t)
                sf = np.asarray([sf_down, sf_up])
                below = cx[None, :, :] < sf[:, None, None]
                row = np.sum(np.where(below, 0.25 * post, 0.25 * pre),
                             axis=(0, 1))
                v[:, j] = torch.as_tensor(row, dtype=v.dtype,
                                          device=v.device)
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
