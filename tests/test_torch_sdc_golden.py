"""The port's compressible_sdc solver against the JAX package's golden
output: acoustic_pulse from its inputs file (pyro2_tpu/test.py's
regression run), 160 SDC steps on the CPU in float64, held to numpy.allclose
at rtol 1e-12 with the golden's step count and time
(tests/test_torch_compressible_golden.py's check).  A file of its own: the
run takes minutes on one thread, and the test runner hands out whole
files to its workers.
"""

import pytest

from test_torch_compressible_golden import (OPTS, SOLVERS, check_golden,
                                           one_thread)  # noqa: F401

pytest.importorskip("h5py")


def test_acoustic_pulse_matches_golden(one_thread):
    check_golden("compressible_sdc", "acoustic_pulse",
                 "inputs.acoustic_pulse", OPTS,
                 SOLVERS / "compressible_sdc" / "tests" /
                 "acoustic_pulse_0160.h5")
