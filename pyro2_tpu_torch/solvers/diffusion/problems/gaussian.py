"""Gaussian diffusion: with constant conductivity a Gaussian stays Gaussian
(peak falls, width grows), giving an analytic verification solution."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.gaussian"

PROBLEM_PARAMS = {"gaussian.t_0": 0.001,
                  "gaussian.phi_0": 1.0,
                  "gaussian.phi_max": 2.0}


def phi_analytic(dist, t, t_0, k, phi_1, phi_2):
    """The analytic solution to the Gaussian diffusion problem."""
    return (phi_2 - phi_1) * (t_0 / (t + t_0)) * \
        np.exp(-0.25 * dist ** 2 / (k * (t + t_0))) + phi_1


def init_data(my_data, rp):
    """Initialize the Gaussian diffusion problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the Gaussian diffusion problem...")

    g = my_data.grid
    xctr = 0.5 * (g.xmin + g.xmax)
    yctr = 0.5 * (g.ymin + g.ymax)

    k = rp.get_param("diffusion.k")
    t_0 = rp.get_param("gaussian.t_0")
    phi_max = rp.get_param("gaussian.phi_max")
    phi_0 = rp.get_param("gaussian.phi_0")

    dist = np.sqrt((g.x2d - xctr) ** 2 + (g.y2d - yctr) ** 2)
    my_data.set_var("phi", phi_analytic(dist, 0.0, t_0, k, phi_0, phi_max))

    my_data.set_aux("k", k)
    my_data.set_aux("t_0", t_0)
    my_data.set_aux("phi_0", phi_0)
    my_data.set_aux("phi_max", phi_max)


def finalize():
    """Print out any information to the user at the end of the run."""
    print("""
          The solution can be compared to the analytic solution with
          the script analysis/gauss_diffusion_compare.py
          """)
