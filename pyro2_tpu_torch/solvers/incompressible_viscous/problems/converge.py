r"""Smooth viscous convergence test: the Minion 1996 traveling solution
damped by exp(-8 pi^2 nu t)."""

from pyro2_tpu_torch.solvers.incompressible.problems.converge import (  # noqa: F401,E501
    PROBLEM_PARAMS, init_data)

DEFAULT_INPUTS = "inputs.converge.64"


def finalize():
    """Print out any information to the user at the end of the run."""
    print("""
          Comparisons to the analytic solution can be done using
          analysis/incomp_viscous_converge_error.py
          """)
