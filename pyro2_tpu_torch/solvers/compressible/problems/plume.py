"""A point heat source drives a buoyant plume in an adiabatically
stratified atmosphere."""

import numpy as np

from pyro2_tpu_torch.solvers.compressible.simulation import energy_source
from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.plume"

PROBLEM_PARAMS = {"plume.dens_base": 10.0,
                  "plume.scale_height": 4.0,
                  "plume.x_pert": 2.0,
                  "plume.y_pert": 2.0,
                  "plume.r_pert": 0.25,
                  "plume.e_rate": 0.1,
                  "plume.dens_cutoff": 0.01}


def init_data(my_data, rp):
    """Initialize the plume problem (adiabatic stratification)."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the plume problem...")

    gamma = rp.get_param("eos.gamma")
    grav = rp.get_param("compressible.grav")
    scale_height = rp.get_param("plume.scale_height")
    dens_base = rp.get_param("plume.dens_base")
    dens_cutoff = rp.get_param("plume.dens_cutoff")

    g = my_data.grid
    dens = np.full((g.qx, g.qy), dens_cutoff)
    p = np.zeros((g.qx, g.qy))
    pres_base = scale_height * dens_base * abs(grav)

    # the hydrostatic pressure, integrated row by row upward
    for j in range(g.jlo, g.jhi + 1):
        profile = 1.0 - (gamma - 1.0) / gamma * g.y[j] / scale_height
        if profile > 0.0:
            dens[:, j] = max(dens_base * profile ** (1.0 / (gamma - 1.0)),
                             dens_cutoff)
        else:
            dens[:, j] = dens_cutoff
        if j == g.jlo:
            p[:, j] = pres_base
        else:
            p[:, j] = p[:, j - 1] + 0.5 * g.dy * (dens[:, j] +
                                                  dens[:, j - 1]) * grav

    ener = p / (gamma - 1.0)
    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", np.zeros_like(dens))
    my_data.set_var("y-momentum", np.zeros_like(dens))
    my_data.set_var("energy", ener)


def source_weight(myg, rp):
    """(e_rate, w): the energy source is rho * e_rate * w, w a Gaussian of
    the distance from the perturbation point (float64, on the host)."""
    x_pert = rp.get_param("plume.x_pert")
    y_pert = rp.get_param("plume.y_pert")
    dist = np.sqrt((myg.x2d - x_pert) ** 2 + (myg.y2d - y_pert) ** 2)
    r_pert = rp.get_param("plume.r_pert")
    return rp.get_param("plume.e_rate"), np.exp(-(dist / r_pert) ** 2)


def source_terms(myg, U, ivars, rp):
    """Gaussian heating at the perturbation point."""
    return energy_source(myg, U, ivars, rp, source_weight)


def finalize():
    """Print out any information to the user at the end of the run."""
