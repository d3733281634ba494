"""The 2-D four-quadrant Riemann problem (Schulz-Rinne et al.): four
constant states meeting at a corner drive interacting shocks and waves;
a classic symmetry test."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.quad"

PROBLEM_PARAMS = {"quadrant.rho1": 1.5,
                  "quadrant.u1": 0.0,
                  "quadrant.v1": 0.0,
                  "quadrant.p1": 1.5,
                  "quadrant.rho2": 0.532258064516129,
                  "quadrant.u2": 1.206045378311055,
                  "quadrant.v2": 0.0,
                  "quadrant.p2": 0.3,
                  "quadrant.rho3": 0.137992831541219,
                  "quadrant.u3": 1.206045378311055,
                  "quadrant.v3": 1.206045378311055,
                  "quadrant.p3": 0.029032258064516,
                  "quadrant.rho4": 0.532258064516129,
                  "quadrant.u4": 0.0,
                  "quadrant.v4": 1.206045378311055,
                  "quadrant.p4": 0.3,
                  "quadrant.cx": 0.5,
                  "quadrant.cy": 0.5}


def init_data(my_data, rp):
    """Initialize the quadrant problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the quadrant problem...")

    gamma = rp.get_param("eos.gamma")
    cx = rp.get_param("quadrant.cx")
    cy = rp.get_param("quadrant.cy")

    g = my_data.grid
    dens = np.zeros((g.qx, g.qy))
    xmom = np.zeros((g.qx, g.qy))
    ymom = np.zeros((g.qx, g.qy))
    ener = np.zeros((g.qx, g.qy))

    quads = {
        1: np.logical_and(g.x2d >= cx, g.y2d >= cy),
        2: np.logical_and(g.x2d < cx, g.y2d >= cy),
        3: np.logical_and(g.x2d < cx, g.y2d < cy),
        4: np.logical_and(g.x2d >= cx, g.y2d < cy),
    }
    for n, idx in quads.items():
        r = rp.get_param(f"quadrant.rho{n}")
        u = rp.get_param(f"quadrant.u{n}")
        v = rp.get_param(f"quadrant.v{n}")
        p = rp.get_param(f"quadrant.p{n}")
        dens[idx] = r
        xmom[idx] = r * u
        ymom[idx] = r * v
        ener[idx] = p / (gamma - 1.0) + 0.5 * r * (u * u + v * v)

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", xmom)
    my_data.set_var("y-momentum", ymom)
    my_data.set_var("energy", ener)


def finalize():
    """Print out any information to the user at the end of the run."""
