r"""A smooth incompressible convergence test (Minion 1996):

    u = 1 - 2 cos(2 pi x) sin(2 pi y)
    v = 1 + 2 sin(2 pi x) cos(2 pi y)

with the exact traveling solution u(x - t, y - t), v(x - t, y - t)."""

import math

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.converge.64"

PROBLEM_PARAMS = {}


def init_data(my_data, rp):
    """Initialize the incompressible converge problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the incompressible converge problem...")

    g = my_data.grid
    if (g.xmin != 0 or g.xmax != 1 or g.ymin != 0 or g.ymax != 1):
        msg.fail("ERROR: domain should be a unit square")

    u = 1.0 - 2.0 * np.cos(2.0 * math.pi * g.x2d) * \
        np.sin(2.0 * math.pi * g.y2d)
    v = 1.0 + 2.0 * np.sin(2.0 * math.pi * g.x2d) * \
        np.cos(2.0 * math.pi * g.y2d)

    my_data.set_var("x-velocity", u)
    my_data.set_var("y-velocity", v)


def finalize():
    """Print out any information to the user at the end of the run."""
    print("""
          Comparisons to the analytic solution can be done using
          analysis/incomp_converge_error.py
          """)
