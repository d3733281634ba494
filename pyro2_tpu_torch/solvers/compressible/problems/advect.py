"""A smooth density perturbation advected at constant velocity and
pressure -- a compressible convergence test (Cartesian and spherical)."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.advect.64"

PROBLEM_PARAMS = {}


def init_data(my_data, rp):
    """Initialize the smooth compressible advection problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the advect problem...")

    gamma = rp.get_param("eos.gamma")
    g = my_data.grid

    xmin = rp.get_param("mesh.xmin")
    xmax = rp.get_param("mesh.xmax")
    ymin = rp.get_param("mesh.ymin")
    ymax = rp.get_param("mesh.ymax")

    if getattr(g, "coord_type", 0) == 0:
        xctr = 0.5 * (xmin + xmax)
        yctr = 0.5 * (ymin + ymax)
        dens = 1.0 + np.exp(-60.0 * ((g.x2d - xctr) ** 2 +
                                     (g.y2d - yctr) ** 2))
        u = 1.0
        v = 1.0
    else:
        # gaussian placed in the projected x-z plane of the r-theta grid
        xctr = 0.5 * (xmin + xmax) * np.sin((ymin + ymax) * 0.25)
        yctr = 0.5 * (xmin + xmax) * np.cos((ymin + ymax) * 0.25)
        x = g.x2d * np.sin(g.y2d)
        y = g.x2d * np.cos(g.y2d)
        dens = 1.0 + np.exp(-120.0 * ((x - xctr) ** 2 + (y - yctr) ** 2))
        u = 0.0
        v = 1.0

    xmom = dens * u
    ymom = dens * v
    p = 1.0
    ener = p / (gamma - 1.0) + 0.5 * (xmom ** 2 + ymom ** 2) / dens

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", xmom)
    my_data.set_var("y-momentum", ymom)
    my_data.set_var("energy", ener)


def finalize():
    """Print out any information to the user at the end of the run."""
