"""The port's multigrid solvers (diffusion, incompressible) against the
JAX package's golden outputs.

The settings are those of pyro2_tpu/test.py's regression runs (diffusion
gaussian from its inputs file; incompressible shear on 64^2 to tmax 0.2),
run by pyro2_tpu_torch on the CPU in float64 and held, each variable over
the valid region, to numpy.allclose at rtol 1e-12 with the golden's step
count and time (tests/test_torch_compressible_golden.py's check).
"""

import pytest

from test_torch_compressible_golden import (OPTS, SOLVERS, check_golden,
                                           one_thread)  # noqa: F401

pytest.importorskip("h5py")

GOLDENS = {
    "diffusion_gaussian": ("diffusion", "gaussian", "inputs.gaussian", OPTS,
                           SOLVERS / "diffusion" / "tests" /
                           "gaussian_0164.h5"),
    "incompressible_shear": ("incompressible", "shear", "inputs.shear",
                             {**OPTS, "mesh.nx": 64, "mesh.ny": 64,
                              "driver.tmax": 0.2},
                             SOLVERS / "incompressible" / "tests" /
                             "shear_128_0023.h5"),
}


@pytest.mark.parametrize("case", list(GOLDENS))
def test_matches_golden(case, one_thread):
    check_golden(*GOLDENS[case])
