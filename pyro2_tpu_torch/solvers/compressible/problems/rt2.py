"""A two-mode Rayleigh-Taylor: short wavelength on the left third of
the domain, long wavelength on the right -- shows growth-rate vs
wavenumber."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.rt2"

PROBLEM_PARAMS = {"rt2.dens1": 1.0,
                  "rt2.dens2": 2.0,
                  "rt2.amp": 1.0,
                  "rt2.sigma": 0.1,
                  "rt2.p0": 10.0}


def init_data(my_data, rp):
    """Initialize the rt2 problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the rt2 problem...")

    gamma = rp.get_param("eos.gamma")
    grav = rp.get_param("compressible.grav")
    dens1 = rp.get_param("rt2.dens1")
    dens2 = rp.get_param("rt2.dens2")
    p0 = rp.get_param("rt2.p0")
    amp = rp.get_param("rt2.amp")
    sigma = rp.get_param("rt2.sigma")

    f_l = 18
    f_r = 3

    g = my_data.grid
    ycenter = 0.5 * (g.ymin + g.ymax)

    dens = np.zeros((g.qx, g.qy))
    p = np.zeros((g.qx, g.qy))
    for j in range(g.jlo, g.jhi + 1):
        if g.y[j] < ycenter:
            dens[:, j] = dens1
            p[:, j] = p0 + dens1 * grav * g.y[j]
        else:
            dens[:, j] = dens2
            p[:, j] = (p0 + dens1 * grav * ycenter +
                       dens2 * grav * (g.y[j] - ycenter))

    L = g.xmax - g.xmin
    left = g.x2d < L / 3.0
    ymom = np.where(
        left,
        amp * np.sin(4.0 * np.pi * f_l * g.x2d / L),
        amp * np.sin(4.0 * np.pi * f_r * g.x2d / L)) * \
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
