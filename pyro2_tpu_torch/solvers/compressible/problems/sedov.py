"""The Sedov blast wave: a point energy deposition into a cold uniform
medium; compared against the exact cylindrical Sedov solution."""

import math

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.sedov"

PROBLEM_PARAMS = {"sedov.r_init": 0.1,   # radius of the initial perturbation
                  "sedov.nsub": 4}


def init_data(my_data, rp):
    """Initialize the Sedov problem (subsampled energy deposition)."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the sedov problem...")

    g = my_data.grid
    gamma = rp.get_param("eos.gamma")
    r_init = rp.get_param("sedov.r_init")

    dens = np.ones((g.qx, g.qy))
    xmom = np.zeros((g.qx, g.qy))
    ymom = np.zeros((g.qx, g.qy))

    if getattr(g, "coord_type", 0) == 0:
        E_sedov = 1.0
        xctr = 0.5 * (rp.get_param("mesh.xmin") + rp.get_param("mesh.xmax"))
        yctr = 0.5 * (rp.get_param("mesh.ymin") + rp.get_param("mesh.ymax"))
        nsub = rp.get_param("sedov.nsub")

        dist = np.sqrt((g.x2d - xctr) ** 2 + (g.y2d - yctr) ** 2)
        ener = np.full((g.qx, g.qy), 1.e-5 / (gamma - 1.0))

        # subsample cells near the perturbation edge so the deposited
        # energy is smooth in area fraction
        for i, j in np.transpose(np.nonzero(dist < 2.0 * r_init)):
            xsub = g.xl[i] + (g.dx / nsub) * (np.arange(nsub) + 0.5)
            ysub = g.yl[j] + (g.dy / nsub) * (np.arange(nsub) + 0.5)
            xx, yy = np.meshgrid(xsub, ysub, indexing="ij")
            d = np.sqrt((xx - xctr) ** 2 + (yy - yctr) ** 2)
            n_in = np.count_nonzero(d <= r_init)
            p = (n_in * (gamma - 1.0) * E_sedov /
                 (math.pi * r_init * r_init) +
                 (nsub * nsub - n_in) * 1.e-5) / (nsub * nsub)
            ener[i, j] = p / (gamma - 1.0)
    else:
        E_sedov = 1.e6
        ener = np.full((g.qx, g.qy), 1.e-6 / (gamma - 1.0))
        ener[g.x2d < r_init] = E_sedov

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", xmom)
    my_data.set_var("y-momentum", ymom)
    my_data.set_var("energy", ener)


def finalize():
    """Print out any information to the user at the end of the run."""
    print("""
          The script analysis/sedov_compare.py can be used to analyze
          these results: it averages at constant radius and compares the
          radial profiles against the exact solution
          (analysis/cylindrical-sedov.out).
          """)
