"""Shallow-water Kelvin-Helmholtz shear layers (McNally-style smoothing),
with a dyed fuel tracer."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.kh"

PROBLEM_PARAMS = {"kh.h_1": 1.0,
                  "kh.v_1": -1.0,
                  "kh.h_2": 2.0,
                  "kh.v_2": 1.0}


def init_data(my_data, rp):
    """Initialize the Kelvin-Helmholtz problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the Kelvin-Helmholtz problem...")

    h_1 = rp.get_param("kh.h_1")
    v_1 = rp.get_param("kh.v_1")
    h_2 = rp.get_param("kh.h_2")
    v_2 = rp.get_param("kh.v_2")

    g = my_data.grid
    y = g.y2d
    dy = 0.025
    w0 = 0.01
    vm = 0.5 * (v_1 - v_2)
    hm = 0.5 * (h_1 - h_2)

    conds = [y < 0.25, (y >= 0.25) & (y < 0.5),
             (y >= 0.5) & (y < 0.75), y >= 0.75]
    height = np.select(conds, [h_1 - hm * np.exp((y - 0.25) / dy),
                               h_2 + hm * np.exp((0.25 - y) / dy),
                               h_2 + hm * np.exp((y - 0.75) / dy),
                               h_1 - hm * np.exp((0.75 - y) / dy)])
    u = np.select(conds, [v_1 - vm * np.exp((y - 0.25) / dy),
                          v_2 + vm * np.exp((0.25 - y) / dy),
                          v_2 + vm * np.exp((y - 0.75) / dy),
                          v_1 - vm * np.exp((0.75 - y) / dy)])
    X = np.select(conds, [1 - 0.5 * np.exp((y - 0.25) / dy),
                          0.5 * np.exp((0.25 - y) / dy),
                          0.5 * np.exp((y - 0.75) / dy),
                          1 - 0.5 * np.exp((0.75 - y) / dy)])

    my_data.set_var("height", height)
    my_data.set_var("x-momentum", u * height)
    my_data.set_var("y-momentum",
                    height * w0 * np.sin(4 * np.pi * g.x2d))
    my_data.set_var("fuel", X * height)


def finalize():
    """Print out any information to the user at the end of the run."""
