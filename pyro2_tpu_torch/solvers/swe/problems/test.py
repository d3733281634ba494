"""A uniform state for unit testing."""

import numpy as np

DEFAULT_INPUTS = None

PROBLEM_PARAMS = {}


def init_data(my_data, rp):
    """Uniform static state: h=1, hu=hv=0."""
    del rp
    g = my_data.grid
    shape = (g.qx, g.qy)
    my_data.set_var("height", np.ones(shape))
    my_data.set_var("x-momentum", np.zeros(shape))
    my_data.set_var("y-momentum", np.zeros(shape))


def finalize():
    """Print out any information to the user at the end of the run."""
