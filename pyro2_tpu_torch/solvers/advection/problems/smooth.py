"""A smooth Gaussian hump (floor 1.0) -- the convergence-test problem."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.smooth"

PROBLEM_PARAMS = {}


def init_data(my_data, rp):
    """Initialize the smooth advection problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the smooth advection problem...")

    g = my_data.grid
    xctr = 0.5 * (g.xmin + g.xmax)
    yctr = 0.5 * (g.ymin + g.ymax)

    dens = 1.0 + np.exp(-60.0 * ((g.x2d - xctr) ** 2 + (g.y2d - yctr) ** 2))
    my_data.set_var("density", dens)


def finalize():
    """Print out any information to the user at the end of the run."""
