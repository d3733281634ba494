"""A uniform state used for unit testing."""

DEFAULT_INPUTS = None

PROBLEM_PARAMS = {}


def init_data(my_data, rp):
    """Uniform phi = 1 everywhere."""
    del rp
    my_data.set_var("phi", my_data.get_var("phi") * 0.0 + 1.0)


def finalize():
    """Print out any information to the user at the end of the run."""
