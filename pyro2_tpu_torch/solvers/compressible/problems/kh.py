"""Kelvin-Helmholtz shear instability: two smooth shear layers with an
optional bulk vertical velocity (McNally et al. 2012 setup)."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.kh"

PROBLEM_PARAMS = {"kh.rho_1": 1.0,
                  "kh.u_1": -1.0,
                  "kh.rho_2": 2.0,
                  "kh.u_2": 1.0,
                  "kh.bulk_velocity": 0.0}


def init_data(my_data, rp):
    """Initialize the Kelvin-Helmholtz problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the Kelvin-Helmholtz problem...")

    rho_1 = rp.get_param("kh.rho_1")
    u_1 = rp.get_param("kh.u_1")
    rho_2 = rp.get_param("kh.rho_2")
    u_2 = rp.get_param("kh.u_2")
    bulk_velocity = rp.get_param("kh.bulk_velocity")
    gamma = rp.get_param("eos.gamma")

    g = my_data.grid
    y = g.y2d

    dy = 0.025
    w0 = 0.01
    vm = 0.5 * (u_1 - u_2)
    rhom = 0.5 * (rho_1 - rho_2)

    # 4 bands, each exponentially smoothed toward the shear layers
    dens = np.select(
        [y < 0.25,
         (y >= 0.25) & (y < 0.5),
         (y >= 0.5) & (y < 0.75),
         y >= 0.75],
        [rho_1 - rhom * np.exp((y - 0.25) / dy),
         rho_2 + rhom * np.exp((0.25 - y) / dy),
         rho_2 + rhom * np.exp((y - 0.75) / dy),
         rho_1 - rhom * np.exp((0.75 - y) / dy)])
    u = np.select(
        [y < 0.25,
         (y >= 0.25) & (y < 0.5),
         (y >= 0.5) & (y < 0.75),
         y >= 0.75],
        [u_1 - vm * np.exp((y - 0.25) / dy),
         u_2 + vm * np.exp((0.25 - y) / dy),
         u_2 + vm * np.exp((y - 0.75) / dy),
         u_1 - vm * np.exp((0.75 - y) / dy)])

    xmom = u * dens
    ymom = dens * (bulk_velocity + w0 * np.sin(4 * np.pi * g.x2d))

    p = 2.5
    ener = p / (gamma - 1.0) + 0.5 * (xmom ** 2 + ymom ** 2) / dens

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", xmom)
    my_data.set_var("y-momentum", ymom)
    my_data.set_var("energy", ener)


def finalize():
    """Print out any information to the user at the end of the run."""
