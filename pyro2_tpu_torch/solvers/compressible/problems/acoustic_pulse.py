"""An acoustic pulse (McCorquodale & Colella 2011): a small smooth
pressure perturbation on a uniform background driving a low-Mach sound
wave -- the convergence-test problem for compressible solvers."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.acoustic_pulse"

PROBLEM_PARAMS = {"acoustic_pulse.rho0": 1.4,
                  "acoustic_pulse.drho0": 0.14}


def init_data(myd, rp):
    """Initialize the acoustic pulse problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the acoustic pulse problem...")

    gamma = rp.get_param("eos.gamma")
    rho0 = rp.get_param("acoustic_pulse.rho0")
    drho0 = rp.get_param("acoustic_pulse.drho0")

    g = myd.grid
    xctr = 0.5 * (rp.get_param("mesh.xmin") + rp.get_param("mesh.xmax"))
    yctr = 0.5 * (rp.get_param("mesh.ymin") + rp.get_param("mesh.ymax"))

    dist = np.sqrt((g.x2d - xctr) ** 2 + (g.y2d - yctr) ** 2)

    dens = np.where(dist <= 0.5,
                    rho0 + drho0 * np.exp(-16 * dist ** 2) *
                    np.cos(np.pi * dist) ** 6,
                    rho0)
    p = (dens / rho0) ** gamma

    myd.set_var("density", dens)
    myd.set_var("x-momentum", np.zeros_like(dens))
    myd.set_var("y-momentum", np.zeros_like(dens))
    myd.set_var("energy", p / (gamma - 1))


def finalize():
    """Print out any information to the user at the end of the run."""
