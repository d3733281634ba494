"""A smooth height pulse driving a gravity wave (convergence test)."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.acoustic_pulse"

PROBLEM_PARAMS = {"acoustic_pulse.h0": 1.4,
                  "acoustic_pulse.dh0": 0.14}


def init_data(myd, rp):
    """Initialize the acoustic pulse problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the acoustic pulse problem...")

    h0 = rp.get_param("acoustic_pulse.h0")
    dh0 = rp.get_param("acoustic_pulse.dh0")

    g = myd.grid
    xctr = 0.5 * (rp.get_param("mesh.xmin") + rp.get_param("mesh.xmax"))
    yctr = 0.5 * (rp.get_param("mesh.ymin") + rp.get_param("mesh.ymax"))
    dist = np.sqrt((g.x2d - xctr) ** 2 + (g.y2d - yctr) ** 2)

    h = np.where(dist <= 0.5,
                 h0 + dh0 * np.exp(-16 * dist ** 2) *
                 np.cos(np.pi * dist) ** 6,
                 h0)
    myd.set_var("height", h)
    myd.set_var("x-momentum", np.zeros_like(h))
    myd.set_var("y-momentum", np.zeros_like(h))
    myd.set_var("fuel", h ** 2 / np.max(h))


def finalize():
    """Print out any information to the user at the end of the run."""
