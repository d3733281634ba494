"""The flame problem: a Sedov-like central energy deposition in a
reacting medium (the port of
pyro2_tpu/solvers/compressible_react/problems/flame.py)."""

import math

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.flame"

PROBLEM_PARAMS = {}


def init_data(my_data, rp):
    """Initialize the flame problem."""
    msg.bold("initializing the flame problem...")

    g = my_data.grid
    gamma = rp.get_param("eos.gamma")

    xctr = 0.5 * (rp.get_param("mesh.xmin") + rp.get_param("mesh.xmax"))
    yctr = 0.5 * (rp.get_param("mesh.ymin") + rp.get_param("mesh.ymax"))
    E_sedov = 1.0
    r_init = 0.1
    nsub = 4

    dens = np.ones((g.qx, g.qy))
    dist = np.sqrt((g.x2d - xctr) ** 2 + (g.y2d - yctr) ** 2)
    ener = np.full((g.qx, g.qy), 1.e-5 / (gamma - 1.0))

    for i, j in np.transpose(np.nonzero(dist < 2.0 * r_init)):
        xsub = g.xl[i] + (g.dx / nsub) * (np.arange(nsub) + 0.5)
        ysub = g.yl[j] + (g.dy / nsub) * (np.arange(nsub) + 0.5)
        xx, yy = np.meshgrid(xsub, ysub, indexing="ij")
        d = np.sqrt((xx - xctr) ** 2 + (yy - yctr) ** 2)
        p_sub = np.where(d <= r_init,
                         (gamma - 1.0) * E_sedov /
                         (math.pi * r_init ** 2), 1.e-5)
        ener[i, j] = p_sub.mean() / (gamma - 1.0)

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", np.zeros_like(dens))
    my_data.set_var("y-momentum", np.zeros_like(dens))
    my_data.set_var("energy", ener)
    my_data.set_var("fuel", dens)
    my_data.set_var("ash", np.zeros_like(dens))


def finalize():
    """Print out any information to the user at the end of the run."""
