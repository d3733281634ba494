r"""The lid-driven cavity: a unit square, no-slip walls, top lid moving
right at unit speed (Re = 1/viscosity)."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.cavity"

PROBLEM_PARAMS = {}


def init_data(my_data, rp):
    """Initialize the lid-driven cavity (fluid at rest)."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the lid-driven cavity problem...")

    g = my_data.grid
    if (g.xmin != 0 or g.xmax != 1 or g.ymin != 0 or g.ymax != 1):
        msg.fail("ERROR: domain should be a unit square")

    my_data.set_var("x-velocity", np.zeros((g.qx, g.qy)))
    my_data.set_var("y-velocity", np.zeros((g.qx, g.qy)))


def finalize():
    """Print out any information to the user at the end of the run."""
