"""A uniform state -- the trivial exactness oracle for unit tests."""

DEFAULT_INPUTS = None

PROBLEM_PARAMS = {}


def init_data(my_data, rp):
    """Uniform density = 1 everywhere."""
    del rp
    g = my_data.grid
    my_data.set_var("density",
                    my_data.get_var("density") * 0.0 + 1.0)
    assert my_data.get_var("density").shape == (g.qx, g.qy)


def finalize():
    """Print out any information to the user at the end of the run."""
