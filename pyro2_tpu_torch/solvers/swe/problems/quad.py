"""The four-quadrant shallow-water Riemann problem with a dyed tracer."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.quad"

PROBLEM_PARAMS = {"quadrant.h1": 1.5,
                  "quadrant.u1": 0.0,
                  "quadrant.v1": 0.0,
                  "quadrant.h2": 0.532258064516129,
                  "quadrant.u2": 1.206045378311055,
                  "quadrant.v2": 0.0,
                  "quadrant.h3": 0.137992831541219,
                  "quadrant.u3": 1.206045378311055,
                  "quadrant.v3": 1.206045378311055,
                  "quadrant.h4": 0.532258064516129,
                  "quadrant.u4": 0.0,
                  "quadrant.v4": 1.206045378311055,
                  "quadrant.cx": 0.5,
                  "quadrant.cy": 0.5}


def init_data(my_data, rp):
    """Initialize the quadrant problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the quadrant problem...")

    cx = rp.get_param("quadrant.cx")
    cy = rp.get_param("quadrant.cy")
    g = my_data.grid

    h = np.zeros((g.qx, g.qy))
    xmom = np.zeros((g.qx, g.qy))
    ymom = np.zeros((g.qx, g.qy))
    X = np.zeros((g.qx, g.qy))

    quads = {
        1: (np.logical_and(g.x2d >= cx, g.y2d >= cy), 1.0),
        2: (np.logical_and(g.x2d < cx, g.y2d >= cy), 0.0),
        3: (np.logical_and(g.x2d < cx, g.y2d < cy), 1.0),
        4: (np.logical_and(g.x2d >= cx, g.y2d < cy), 0.0),
    }
    for n, (idx, dye) in quads.items():
        r = rp.get_param(f"quadrant.h{n}")
        u = rp.get_param(f"quadrant.u{n}")
        v = rp.get_param(f"quadrant.v{n}")
        h[idx] = r
        xmom[idx] = r * u
        ymom[idx] = r * v
        X[idx] = dye

    my_data.set_var("height", h)
    my_data.set_var("x-momentum", xmom)
    my_data.set_var("y-momentum", ymom)
    my_data.set_var("fuel", X * h)


def finalize():
    """Print out any information to the user at the end of the run."""
