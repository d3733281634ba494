"""A uniform state (with unit rotation-free velocity) for unit testing."""

import numpy as np

DEFAULT_INPUTS = None

PROBLEM_PARAMS = {}


def init_data(my_data, rp):
    """Uniform density and velocity."""
    del rp
    g = my_data.grid
    shape = (g.qx, g.qy)
    my_data.set_var("density", np.ones(shape))
    my_data.set_var("x-velocity", np.ones(shape))
    my_data.set_var("y-velocity", np.ones(shape))


def finalize():
    """Print out any information to the user at the end of the run."""
