"""A diagonal shock: velocity (3,3) below the line y = -x + 1, (1,1) above,
driving a shock from lower-left to upper-right."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.test"

PROBLEM_PARAMS = {}


def init_data(myd, rp):
    """Initialize the burgers test problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the burgers test problem...")

    g = myd.grid
    above = g.y2d > -1.0 * g.x2d + 1.0
    myd.set_var("x-velocity", np.where(above, 1.0, 3.0))
    myd.set_var("y-velocity", np.where(above, 1.0, 3.0))


def finalize():
    """Print out any information to the user at the end of the run."""
