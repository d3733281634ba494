"""The Gresho vortex: a toroidal velocity field balanced by a radial
pressure gradient -- an exact stationary equilibrium (Miczek, Roepke &
Edelmann 2014 formulation)."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.gresho"

PROBLEM_PARAMS = {"gresho.rho0": 1.0,
                  "gresho.r": 0.2,
                  "gresho.mach": 0.1,
                  "gresho.t_r": 1.0}


def init_data(my_data, rp):
    """Initialize the Gresho vortex problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the Gresho vortex problem...")

    g = my_data.grid
    x_center = 0.5 * (g.x[0] + g.x[-1])
    y_center = 0.5 * (g.y[0] + g.y[-1])
    L_x = g.xmax - g.xmin

    gamma = rp.get_param("eos.gamma")
    rho0 = rp.get_param("gresho.rho0")
    M = rp.get_param("gresho.mach")
    rr = rp.get_param("gresho.r")
    t_r = rp.get_param("gresho.t_r")

    q_r = 0.4 * np.pi * L_x / t_r
    p0 = rho0 * q_r ** 2 * (5 * rr) ** 2 / (gamma * M ** 2) - 12.5 * rr ** 2

    rad = np.sqrt((g.x2d - x_center) ** 2 + (g.y2d - y_center) ** 2)

    u_phi = np.select(
        [rad < rr, rad < 2.0 * rr],
        [5.0 * rad, 2.0 - 5.0 * rad], 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        pres = np.select(
            [rad < rr, rad < 2.0 * rr],
            [p0 + 12.5 * rad ** 2,
             p0 + 12.5 * rad ** 2 +
             4.0 * (1.0 - 5.0 * rad - np.log(rr) + np.log(rad))],
            p0 + 12.5 * (2.0 * rr) ** 2 +
            4.0 * (1.0 - 5.0 * (2.0 * rr) - np.log(rr) + np.log(2.0 * rr)))

    dens = np.full((g.qx, g.qy), rho0)
    safe_rad = np.where(rad == 0.0, 1.0, rad)
    xmom = -dens * q_r * u_phi * (g.y2d - y_center) / safe_rad
    ymom = dens * q_r * u_phi * (g.x2d - x_center) / safe_rad
    ener = pres / (gamma - 1.0) + 0.5 * (xmom ** 2 + ymom ** 2) / dens

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", xmom)
    my_data.set_var("y-momentum", ymom)
    my_data.set_var("energy", ener)

    cs = np.sqrt(gamma * pres / dens)
    print(f"peak Mach number = {np.abs(q_r * u_phi).max() / cs.max()}")


def finalize():
    """Print out any information to the user at the end of the run."""
