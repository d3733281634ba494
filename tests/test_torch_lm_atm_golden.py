"""The port's low-Mach atmosphere solver against the JAX package's golden
output.

pyro2_tpu/solvers/lm_atm/tests/lm_bubble_128_0020.h5 holds the bubble of
`inputs.bubble` on a 64x64 grid (despite its name) after 20 steps; the JAX
package reproduces it exactly.  The port runs the same settings on the CPU
in float64 and is held, each of the 8 variables over the valid region, to
the JAX package's comparison (pyro2_tpu/util/compare.py: numpy.allclose at
rtol 1e-12), with the golden's step count and time.  h5py reads the golden
here; the port itself needs no h5py for this run.
"""

from pathlib import Path

import numpy as np
import pytest

from pyro2_tpu_torch import Pyro

h5py = pytest.importorskip("h5py")

GOLDEN = (Path(__file__).resolve().parents[1] / "pyro2_tpu" / "solvers" /
          "lm_atm" / "tests" / "lm_bubble_128_0020.h5")


@pytest.fixture
def one_thread():
    """The grid is small: one intra-op thread runs it fastest, and keeps
    parallel test workers from oversubscribing the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bubble_matches_golden(one_thread):
    p = Pyro("lm_atm", device="cpu")
    p.initialize_problem("bubble", inputs_dict={
        "mesh.nx": 64, "mesh.ny": 64, "driver.max_steps": 20,
        "driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0})
    p.run_sim()
    g = p.get_grid()
    with h5py.File(GOLDEN, "r") as f:
        assert int(f.attrs["nsteps"]) == p.sim.n == 20
        assert float(f.attrs["time"]) == pytest.approx(p.sim.cc_data.t,
                                                       rel=1e-12)
        names = sorted(f["state"])
        assert names == sorted(p.sim.cc_data.names) and len(names) == 8
        for name in names:
            ref = f["state"][name]["data"][()]
            got = p.get_var(name)[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1].numpy()
            assert np.allclose(got, ref, rtol=1e-12), \
                (name, np.abs(got - ref).max())
