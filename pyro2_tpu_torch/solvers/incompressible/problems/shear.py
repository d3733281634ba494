r"""The doubly-periodic shear layer (Martin & Colella 2000): tanh shear
layers at y = 1/4 and 3/4 with a sinusoidal v perturbation."""

import math

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.shear"

PROBLEM_PARAMS = {"shear.rho_s": 42.0,      # shear layer width
                  "shear.delta_s": 0.05}    # perturbation amplitude


def init_data(my_data, rp):
    """Initialize the incompressible shear problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the incompressible shear problem...")

    rho_s = rp.get_param("shear.rho_s")
    delta_s = rp.get_param("shear.delta_s")

    g = my_data.grid
    if (g.xmin != 0 or g.xmax != 1 or g.ymin != 0 or g.ymax != 1):
        msg.fail("ERROR: domain should be a unit square")

    y_half = 0.5 * (g.ymin + g.ymax)
    u = np.where(g.y2d <= y_half,
                 np.tanh(rho_s * (g.y2d - 0.25)),
                 np.tanh(rho_s * (0.75 - g.y2d)))
    v = delta_s * np.sin(2.0 * math.pi * g.x2d)

    my_data.set_var("x-velocity", u)
    my_data.set_var("y-velocity", v)


def finalize():
    """Print out any information to the user at the end of the run."""
