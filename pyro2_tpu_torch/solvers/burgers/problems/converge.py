"""A smooth Gaussian velocity field for convergence testing."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.converge.64"

PROBLEM_PARAMS = {}


def init_data(my_data, rp):
    """Initialize the smooth burgers convergence problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the smooth burgers convergence problem...")

    g = my_data.grid
    xctr = 0.5 * (g.xmin + g.xmax)
    yctr = 0.5 * (g.ymin + g.ymax)

    A = 0.05
    vel = A + A * np.exp(-50.0 * ((g.x2d - xctr) ** 2 +
                                  (g.y2d - yctr) ** 2))
    my_data.set_var("x-velocity", vel)
    my_data.set_var("y-velocity", vel)


def finalize():
    """Print out any information to the user at the end of the run."""
