"""A circular tophat: 1 inside radius 0.1, 0 outside -- exercises the
limiters hard."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.tophat"

PROBLEM_PARAMS = {}


def init_data(myd, rp):
    """Initialize the tophat advection problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the tophat advection problem...")

    g = myd.grid
    xctr = 0.5 * (g.xmin + g.xmax)
    yctr = 0.5 * (g.ymin + g.ymax)
    R = 0.1

    inside = (g.x2d - xctr) ** 2 + (g.y2d - yctr) ** 2 < R ** 2
    myd.set_var("density", np.where(inside, 1.0, 0.0))


def finalize():
    """Print out any information to the user at the end of the run."""
