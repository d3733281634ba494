"""The dam-break problem: a shallow-water Riemann problem with an
analytic solution (analysis/dam_compare.py)."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.dam.x"

PROBLEM_PARAMS = {"dam.direction": "x",
                  "dam.h_left": 1.0,
                  "dam.h_right": 0.125,
                  "dam.u_left": 0.0,
                  "dam.u_right": 0.0}


def init_data(my_data, rp):
    """Initialize the dam problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the dam problem...")

    h_l = rp.get_param("dam.h_left")
    h_r = rp.get_param("dam.h_right")
    u_l = rp.get_param("dam.u_left")
    u_r = rp.get_param("dam.u_right")
    direction = rp.get_param("dam.direction")

    g = my_data.grid
    xctr = 0.5 * (rp.get_param("mesh.xmin") + rp.get_param("mesh.xmax"))
    yctr = 0.5 * (rp.get_param("mesh.ymin") + rp.get_param("mesh.ymax"))

    left = g.x2d <= xctr if direction == "x" else g.y2d <= yctr

    h = np.where(left, h_l, h_r)
    mom = np.where(left, h_l * u_l, h_r * u_r)
    X = np.where(left, 1.0, 0.0) * h

    my_data.set_var("height", h)
    my_data.set_var("fuel", X)
    if direction == "x":
        my_data.set_var("x-momentum", mom)
        my_data.set_var("y-momentum", np.zeros_like(h))
    else:
        my_data.set_var("x-momentum", np.zeros_like(h))
        my_data.set_var("y-momentum", mom)


def finalize():
    """Print out any information to the user at the end of the run."""
    print("""
          The script analysis/dam_compare.py can be used to compare
          this output to the exact solution.
          """)
