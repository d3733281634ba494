"""The Sod shock tube: a general left/right (or bottom/top) Riemann
problem with an exact solution for comparison
(reference: pyro/compressible/problems/sod.py)."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.sod.x"

PROBLEM_PARAMS = {"sod.direction": "x",
                  "sod.dens_left": 1.0,
                  "sod.dens_right": 0.125,
                  "sod.u_left": 0.0,
                  "sod.u_right": 0.0,
                  "sod.p_left": 1.0,
                  "sod.p_right": 0.1}


def init_data(my_data, rp):
    """Initialize the sod problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the sod problem...")

    dens_l = rp.get_param("sod.dens_left")
    dens_r = rp.get_param("sod.dens_right")
    u_l = rp.get_param("sod.u_left")
    u_r = rp.get_param("sod.u_right")
    p_l = rp.get_param("sod.p_left")
    p_r = rp.get_param("sod.p_right")

    gamma = rp.get_param("eos.gamma")
    direction = rp.get_param("sod.direction")

    g = my_data.grid
    xctr = 0.5 * (rp.get_param("mesh.xmin") + rp.get_param("mesh.xmax"))
    yctr = 0.5 * (rp.get_param("mesh.ymin") + rp.get_param("mesh.ymax"))

    if direction == "x":
        left = g.x2d <= xctr
    else:
        left = g.y2d <= yctr

    dens = np.where(left, dens_l, dens_r)
    mom_n = np.where(left, dens_l * u_l, dens_r * u_r)
    ener = np.where(left,
                    p_l / (gamma - 1.0) + 0.5 * dens_l * u_l ** 2,
                    p_r / (gamma - 1.0) + 0.5 * dens_r * u_r ** 2)

    my_data.set_var("density", dens)
    my_data.set_var("energy", ener)
    if direction == "x":
        my_data.set_var("x-momentum", mom_n)
        my_data.set_var("y-momentum", np.zeros_like(dens))
    else:
        my_data.set_var("x-momentum", np.zeros_like(dens))
        my_data.set_var("y-momentum", mom_n)


def finalize():
    """Print out any information to the user at the end of the run."""
    print("""
          The script analysis/sod_compare.py can be used to compare
          this output to the exact solution.  Some sample exact solution
          data is present as analysis/sod-exact.out
          """)
