"""A smooth height bump advected diagonally (convergence test)."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.advect"

PROBLEM_PARAMS = {}


def init_data(my_data, rp):
    """Initialize the advect problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the advect problem...")

    g = my_data.grid
    xctr = 0.5 * (rp.get_param("mesh.xmin") + rp.get_param("mesh.xmax"))
    yctr = 0.5 * (rp.get_param("mesh.ymin") + rp.get_param("mesh.ymax"))

    h = 1.0 + np.exp(-60.0 * ((g.x2d - xctr) ** 2 + (g.y2d - yctr) ** 2))
    my_data.set_var("height", h)
    my_data.set_var("x-momentum", h * 1.0)
    my_data.set_var("y-momentum", h * 1.0)
    my_data.set_var("fuel", h ** 2 / np.max(h))


def finalize():
    """Print out any information to the user at the end of the run."""
