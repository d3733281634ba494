"""A single-mode Rayleigh-Taylor instability: dense fluid over light in
gravity, perturbed by one cosine mode."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.rt"

PROBLEM_PARAMS = {"rt.dens1": 1.0,
                  "rt.dens2": 2.0,
                  "rt.amp": 1.0,
                  "rt.sigma": 0.1,
                  "rt.p0": 10.0}


def init_data(my_data, rp):
    """Initialize the rt problem."""
    if rp.get_param("driver.verbose"):
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

    # hydrostatic stratification per row (interior rows only, like the
    # reference's jlo..jhi loop)
    for j in range(g.jlo, g.jhi + 1):
        if g.y[j] < ycenter:
            dens[:, j] = dens1
            p[:, j] = p0 + dens1 * grav * g.y[j]
        else:
            dens[:, j] = dens2
            p[:, j] = (p0 + dens1 * grav * ycenter +
                       dens2 * grav * (g.y[j] - ycenter))

    L = g.xmax - g.xmin
    ymom = amp * 0.5 * (np.cos(2.0 * np.pi * g.x2d / L) +
                        np.cos(2.0 * np.pi * (L - g.x2d) / L)) * \
        np.exp(-(g.y2d - ycenter) ** 2 / sigma ** 2)
    ymom = ymom * dens
    xmom = np.zeros_like(dens)

    with np.errstate(divide="ignore", invalid="ignore"):
        ener = p / (gamma - 1.0) + \
            np.where(dens > 0.0, 0.5 * (xmom ** 2 + ymom ** 2) / dens, 0.0)

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", xmom)
    my_data.set_var("y-momentum", ymom)
    my_data.set_var("energy", ener)


def finalize():
    """Print out any information to the user at the end of the run."""
