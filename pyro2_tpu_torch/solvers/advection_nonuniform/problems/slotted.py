"""The slotted-cylinder rotation (Zalesak) problem: a circular profile
with a rectangular slot, rotated rigidly about the domain center."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.slotted"

PROBLEM_PARAMS = {"slotted.omega": 0.5,    # angular velocity
                  "slotted.offset": 0.25}  # slot offset from domain center


def init_data(my_data, rp):
    """Initialize the slotted advection problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the slotted advection problem...")

    offset = rp.get_param("slotted.offset")
    omega = rp.get_param("slotted.omega")

    g = my_data.grid
    xctr_dens = 0.5 * (g.xmin + g.xmax)
    yctr_dens = 0.5 * (g.ymin + g.ymax) + offset

    R = 0.15
    slot_width = 0.05
    inside = (g.x2d - xctr_dens) ** 2 + (g.y2d - yctr_dens) ** 2 < R ** 2
    slot = (np.abs(g.x2d - xctr_dens) < slot_width * 0.5) & \
        (g.y2d > (yctr_dens - R)) & (g.y2d < yctr_dens)

    dens = np.where(inside & ~slot, 1.0, 0.0)
    my_data.set_var("density", dens)
    my_data.set_var("x-velocity", omega * (g.y2d - xctr_dens))
    my_data.set_var("y-velocity", -omega * (g.x2d - (yctr_dens - offset)))


def finalize():
    """Print out any information to the user at the end of the run."""
