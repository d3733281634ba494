"""The port's method-of-lines solvers against the JAX package's golden
outputs.

The settings are those of pyro2_tpu/test.py's regression runs
(compressible_rk rt to tmax 0.5; compressible_fv4 acoustic_pulse from its
inputs file), run by pyro2_tpu_torch on the CPU in float64 and held, each
variable over the valid region, to the JAX package's comparison
(pyro2_tpu/util/compare.py: numpy.allclose at rtol 1e-12).  The goldens
hold the step count and time of the run that wrote them; the port's run
must reach the same.  h5py reads the goldens here; the port itself needs
no h5py for these runs.
"""

from pathlib import Path

import numpy as np
import pytest

from pyro2_tpu_torch import Pyro

h5py = pytest.importorskip("h5py")

ROOT = Path(__file__).resolve().parents[1]
SOLVERS = ROOT / "pyro2_tpu" / "solvers"

OPTS = {"driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0}

GOLDENS = {
    "rk_rt": ("compressible_rk", "rt", "inputs.rt",
              {**OPTS, "driver.tmax": 0.5},
              SOLVERS / "compressible_rk" / "tests" / "rt_0307.h5"),
    "fv4_acoustic_pulse": ("compressible_fv4", "acoustic_pulse",
                           "inputs.acoustic_pulse", OPTS,
                           SOLVERS / "compressible_fv4" / "tests" /
                           "acoustic_pulse_0160.h5"),
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


@pytest.mark.parametrize("case", list(GOLDENS))
def test_matches_golden(case, one_thread):
    solver, problem, inputs_file, inputs, golden = GOLDENS[case]
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
