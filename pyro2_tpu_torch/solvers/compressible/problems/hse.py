"""An isothermal hydrostatic atmosphere that should remain static --
tests the gravitational source-term treatment."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.hse"

PROBLEM_PARAMS = {"hse.dens0": 1.0,
                  "hse.h": 1.0}


def init_data(my_data, rp):
    """Initialize the HSE problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the HSE problem...")

    gamma = rp.get_param("eos.gamma")
    grav = rp.get_param("compressible.grav")
    dens0 = rp.get_param("hse.dens0")
    H = rp.get_param("hse.h")
    cs2 = H * abs(grav)

    g = my_data.grid
    dens = np.zeros((g.qx, g.qy))
    p = np.zeros((g.qx, g.qy))

    for j in range(g.jlo, g.jhi + 1):
        dens[:, j] = dens0 * np.exp(-g.y[j] / H)
        if j == g.jlo:
            p[:, j] = dens[:, j] * cs2
        else:
            p[:, j] = p[:, j - 1] + 0.5 * g.dy * (dens[:, j] +
                                                  dens[:, j - 1]) * grav

    with np.errstate(divide="ignore", invalid="ignore"):
        ener = np.where(dens > 0.0, p / (gamma - 1.0), 0.0)

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", np.zeros_like(dens))
    my_data.set_var("y-momentum", np.zeros_like(dens))
    my_data.set_var("energy", ener)


def finalize():
    """Print out any information to the user at the end of the run."""
