"""The doubly-periodic shear layer with viscosity (same ICs as the
inviscid incompressible version)."""

from pyro2_tpu_torch.solvers.incompressible.problems.shear import (  # noqa: F401,E501
    PROBLEM_PARAMS, finalize, init_data)

DEFAULT_INPUTS = "inputs.shear"
