"""The double Mach reflection: a Mach-10 shock hits a ramp at an
oblique angle (Woodward & Colella 1984).  The initial front is laid in
with a 4-point subcell quadrature."""

import math

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.ramp"

PROBLEM_PARAMS = {"ramp.rhol": 8.0,
                  "ramp.ul": 7.1447096,
                  "ramp.vl": -4.125,
                  "ramp.pl": 116.5,
                  "ramp.rhor": 1.4,
                  "ramp.ur": 0.0,
                  "ramp.vr": 0.0,
                  "ramp.pr": 1.0}


def init_data(my_data, rp):
    """Initialize the double Mach reflection problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the double Mach reflection problem...")

    r_l = rp.get_param("ramp.rhol")
    u_l = rp.get_param("ramp.ul")
    v_l = rp.get_param("ramp.vl")
    p_l = rp.get_param("ramp.pl")
    r_r = rp.get_param("ramp.rhor")
    u_r = rp.get_param("ramp.ur")
    v_r = rp.get_param("ramp.vr")
    p_r = rp.get_param("ramp.pr")
    gamma = rp.get_param("eos.gamma")

    energy_l = p_l / (gamma - 1.0) + 0.5 * r_l * (u_l ** 2 + v_l ** 2)
    energy_r = p_r / (gamma - 1.0) + 0.5 * r_r * (u_r ** 2 + v_r ** 2)

    g = my_data.grid
    dens = np.full((g.qx, g.qy), 1.4)
    xmom = np.zeros((g.qx, g.qy))
    ymom = np.zeros((g.qx, g.qy))
    ener = np.zeros((g.qx, g.qy))

    # 60-degree shock through x = 1/6 at y = 0; blend the two states by
    # the fraction of the 4 quadrature points above the front
    s3 = 0.5 * math.sqrt(3)
    tan60 = math.tan(math.pi / 3.0)
    cy = np.stack([g.y - s3 * g.dy, g.y + s3 * g.dy])          # (2, qy)
    sf = tan60 * np.stack([g.x - s3 * g.dx - 1.0 / 6.0,
                           g.x + s3 * g.dx - 1.0 / 6.0])       # (2, qx)

    # above[a, b, i, j] = cy[b, j] >= sf[a, i]
    above = cy[None, :, None, :] >= sf[:, None, :, None]
    frac = above.mean(axis=(0, 1))                             # (qx, qy)

    isl = slice(g.ilo, g.ihi + 1)
    jsl = slice(g.jlo, g.jhi + 1)
    dens[isl, jsl] = (frac * r_l + (1 - frac) * r_r)[isl, jsl]
    xmom[isl, jsl] = (frac * r_l * u_l + (1 - frac) * r_r * u_r)[isl, jsl]
    ymom[isl, jsl] = (frac * r_l * v_l + (1 - frac) * r_r * v_r)[isl, jsl]
    ener[isl, jsl] = (frac * energy_l + (1 - frac) * energy_r)[isl, jsl]

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", xmom)
    my_data.set_var("y-momentum", ymom)
    my_data.set_var("energy", ener)


def finalize():
    """Print out any information to the user at the end of the run."""
