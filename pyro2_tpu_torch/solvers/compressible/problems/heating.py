"""A test of energy sources: heat slowly added at the domain center."""

import numpy as np

from pyro2_tpu_torch.solvers.compressible.simulation import energy_source
from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.heating"

PROBLEM_PARAMS = {"heating.rho_ambient": 1.0,
                  "heating.p_ambient": 10.0,
                  "heating.r_src": 0.1,
                  "heating.e_rate": 0.1}


def init_data(my_data, rp):
    """Initialize the heating problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the heating problem...")

    gamma = rp.get_param("eos.gamma")
    g = my_data.grid
    shape = (g.qx, g.qy)
    my_data.set_var("density",
                    np.full(shape, rp.get_param("heating.rho_ambient")))
    my_data.set_var("x-momentum", np.zeros(shape))
    my_data.set_var("y-momentum", np.zeros(shape))
    my_data.set_var("energy",
                    np.full(shape,
                            rp.get_param("heating.p_ambient") /
                            (gamma - 1.0)))


def source_weight(myg, rp):
    """(e_rate, w): the energy source is rho * e_rate * w, w a Gaussian of
    the distance from the domain center (float64, on the host)."""
    xctr = 0.5 * (myg.xmin + myg.xmax)
    yctr = 0.5 * (myg.ymin + myg.ymax)
    dist = np.sqrt((myg.x2d - xctr) ** 2 + (myg.y2d - yctr) ** 2)
    r_src = rp.get_param("heating.r_src")
    return rp.get_param("heating.e_rate"), np.exp(-(dist / r_src) ** 2)


def source_terms(myg, U, ivars, rp):
    """Gaussian central heating source."""
    return energy_source(myg, U, ivars, rp, source_weight)


def finalize():
    """Print out any information to the user at the end of the run."""
    print("""
          The script analysis/sedov_compare.py can be used to analyze
          these results.
          """)
