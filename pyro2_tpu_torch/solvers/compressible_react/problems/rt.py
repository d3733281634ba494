"""Reacting Rayleigh-Taylor: the rt setup with fuel above and ash below
(the port of pyro2_tpu/solvers/compressible_react/problems/rt.py).

`Pyro("compressible_react").initialize_problem("rt")` does not reach this
module: the package's aliasing of the base problems, which the JAX package
does the same way, puts the base compressible rt under this module's name
first, so both packages run the base rt with fuel and ash left at zero.
"""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.rt"

PROBLEM_PARAMS = {"rt.dens1": 1.0,
                  "rt.dens2": 2.0,
                  "rt.amp": 1.0,
                  "rt.sigma": 0.1,
                  "rt.p0": 10.0}


def init_data(my_data, rp):
    """Initialize the reacting rt problem."""
    msg.bold("initializing the rt problem...")

    gamma = rp.get_param("eos.gamma")
    grav = rp.get_param("compressible.grav")
    dens1 = rp.get_param("rt.dens1")
    dens2 = rp.get_param("rt.dens2")
    p0 = rp.get_param("rt.p0")
    amp = rp.get_param("rt.amp")
    sigma = rp.get_param("rt.sigma")

    g = my_data.grid
    ycenter = 0.5 * (g.ymin + g.ymax)

    dens = np.zeros((g.qx, g.qy))
    p = np.zeros((g.qx, g.qy))
    fuel = np.zeros((g.qx, g.qy))
    ash = np.zeros((g.qx, g.qy))

    for j in range(g.jlo, g.jhi + 1):
        if g.y[j] < ycenter:
            dens[:, j] = dens1
            p[:, j] = p0 + dens1 * grav * g.y[j]
            ash[:, j] = dens1
        else:
            dens[:, j] = dens2
            p[:, j] = (p0 + dens1 * grav * ycenter +
                       dens2 * grav * (g.y[j] - ycenter))
            fuel[:, j] = dens2

    ymom = amp * np.cos(2.0 * np.pi * g.x2d / (g.xmax - g.xmin)) * \
        np.exp(-(g.y2d - ycenter) ** 2 / sigma ** 2) * dens
    xmom = np.zeros_like(dens)

    with np.errstate(divide="ignore", invalid="ignore"):
        ener = p / (gamma - 1.0) + \
            np.where(dens > 0.0, 0.5 * (xmom ** 2 + ymom ** 2) / dens, 0.0)

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", xmom)
    my_data.set_var("y-momentum", ymom)
    my_data.set_var("energy", ener)
    my_data.set_var("fuel", fuel)
    my_data.set_var("ash", ash)


def finalize():
    """Print out any information to the user at the end of the run."""
