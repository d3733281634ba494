"""The port's compressible CTU solver against the JAX package's golden
outputs.

The settings are those of pyro2_tpu/test.py's regression runs (quad on
128^2, sod from inputs.sod.x, rt to tmax 1.0), run by pyro2_tpu_torch on
the CPU in float64 and held, each variable over the valid region, to the
JAX package's comparison (pyro2_tpu/util/compare.py: numpy.allclose at
rtol 1e-12).  The goldens hold the step count and time of the run that
wrote them; the port's run must reach the same.  h5py reads the goldens
here; the port itself needs no h5py for these runs.
"""

from pathlib import Path

import numpy as np
import pytest

from pyro2_tpu_torch import Pyro

h5py = pytest.importorskip("h5py")

SOLVERS = Path(__file__).resolve().parents[1] / "pyro2_tpu" / "solvers"
TESTS = SOLVERS / "compressible" / "tests"

OPTS = {"driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0}

GOLDENS = {
    "sod_x": ("compressible", "sod", "inputs.sod.x", OPTS,
              TESTS / "sod_x_0076.h5"),
    "quad_128": ("compressible", "quad", "inputs.quad",
                 {**OPTS, "mesh.nx": 128, "mesh.ny": 128},
                 TESTS / "quad_unsplit_0294.h5"),
    "rt": ("compressible", "rt", "inputs.rt", {**OPTS, "driver.tmax": 1.0},
           TESTS / "rt_0307.h5"),
}


@pytest.fixture
def one_thread():
    """These grids are small: one intra-op thread runs them fastest, and
    keeps parallel test workers from oversubscribing the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def check_golden(solver, problem, inputs_file, inputs, golden):
    """Run the port and hold every variable's valid region to the
    golden at rtol 1e-12, with the golden's step count and time."""
    p = Pyro(solver, device="cpu")
    p.initialize_problem(problem, inputs_file=inputs_file,
                         inputs_dict=inputs)
    p.run_sim()
    g = p.get_grid()
    with h5py.File(golden, "r") as f:
        assert int(f.attrs["nsteps"]) == p.sim.n
        assert float(f.attrs["time"]) == pytest.approx(p.sim.cc_data.t,
                                                       rel=1e-12)
        names = sorted(f["state"])
        assert names == sorted(p.sim.cc_data.names)
        for name in names:
            ref = f["state"][name]["data"][()]
            got = p.get_var(name)[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1].numpy()
            assert np.allclose(got, ref, rtol=1e-12), \
                (name, np.abs(got - ref).max())


@pytest.mark.parametrize("case", list(GOLDENS))
def test_matches_golden(case, one_thread):
    check_golden(*GOLDENS[case])
