"""A buoyant bubble in an isothermal plane-parallel hydrostatic
atmosphere; it rises and shears apart."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.bubble"

PROBLEM_PARAMS = {"bubble.dens_base": 10.0,
                  "bubble.scale_height": 2.0,
                  "bubble.x_pert": 2.0,
                  "bubble.y_pert": 2.0,
                  "bubble.r_pert": 0.25,
                  "bubble.pert_amplitude_factor": 5.0,
                  "bubble.dens_cutoff": 0.01}


def init_data(my_data, rp):
    """Initialize the bubble problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the bubble problem...")

    gamma = rp.get_param("eos.gamma")
    grav = rp.get_param("compressible.grav")
    scale_height = rp.get_param("bubble.scale_height")
    dens_base = rp.get_param("bubble.dens_base")
    dens_cutoff = rp.get_param("bubble.dens_cutoff")
    x_pert = rp.get_param("bubble.x_pert")
    y_pert = rp.get_param("bubble.y_pert")
    r_pert = rp.get_param("bubble.r_pert")
    pert_amplitude_factor = rp.get_param("bubble.pert_amplitude_factor")

    g = my_data.grid
    dens = np.full((g.qx, g.qy), dens_cutoff)
    xmom = np.zeros((g.qx, g.qy))
    ymom = np.zeros((g.qx, g.qy))
    p = np.zeros((g.qx, g.qy))

    cs2 = scale_height * abs(grav)

    # isothermal atmosphere, discretely hydrostatic (trapezoid rule)
    for j in range(g.jlo, g.jhi + 1):
        dens[:, j] = max(dens_base * np.exp(-g.y[j] / scale_height),
                         dens_cutoff)
        if j == g.jlo:
            p[:, j] = dens[:, j] * cs2
        else:
            p[:, j] = p[:, j - 1] + 0.5 * g.dy * (dens[:, j] +
                                                  dens[:, j - 1]) * grav

    ener = p / (gamma - 1.0) + 0.5 * (xmom ** 2 + ymom ** 2) / dens

    # perturb: boost eint inside the bubble at constant pressure
    r = np.sqrt((g.x2d - x_pert) ** 2 + (g.y2d - y_pert) ** 2)
    idx = r <= r_pert
    eint = (ener[idx] - 0.5 * (xmom[idx] ** 2 - ymom[idx] ** 2) /
            dens[idx]) / dens[idx]
    pres = dens[idx] * eint * (gamma - 1.0)
    eint = eint * pert_amplitude_factor
    dens[idx] = pres / (eint * (gamma - 1.0))
    ener[idx] = dens[idx] * eint + 0.5 * (xmom[idx] ** 2 +
                                          ymom[idx] ** 2) / dens[idx]

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", xmom)
    my_data.set_var("y-momentum", ymom)
    my_data.set_var("energy", ener)


def finalize():
    """Print out any information to the user at the end of the run."""
