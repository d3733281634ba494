"""The port's shallow-water solver against the JAX package's golden output.

`dam` from `inputs.dam.x` (reflecting y walls by default, Roe, limiter 1)
run to tmax 0.3 by pyro2_tpu_torch on the CPU in float64, held, each
variable over the valid region, to pyro2_tpu/solvers/swe/tests/
dam_x_0081.h5 with the JAX package's comparison (pyro2_tpu/util/compare.py:
numpy.allclose at rtol 1e-12).  The golden holds the step count and time
of the run that wrote it; the port's run must reach the same.  h5py reads
the golden here; the port itself needs no h5py for this run.
"""

from pathlib import Path

import numpy as np
import pytest

from pyro2_tpu_torch import Pyro

h5py = pytest.importorskip("h5py")

GOLDEN = (Path(__file__).resolve().parents[1] / "pyro2_tpu" / "solvers" /
          "swe" / "tests" / "dam_x_0081.h5")


def test_dam_x_matches_golden():
    p = Pyro("swe", device="cpu")
    p.initialize_problem("dam", inputs_file="inputs.dam.x", inputs_dict={
        "driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0})
    p.run_sim()
    g = p.get_grid()
    with h5py.File(GOLDEN, "r") as f:
        assert int(f.attrs["nsteps"]) == p.sim.n == 81
        assert float(f.attrs["time"]) == pytest.approx(p.sim.cc_data.t,
                                                       rel=1e-12)
        names = sorted(f["state"])
        assert names == sorted(p.sim.cc_data.names)
        for name in names:
            ref = f["state"][name]["data"][()]
            got = p.get_var(name)[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1].numpy()
            assert np.allclose(got, ref, rtol=1e-12), \
                (name, np.abs(got - ref).max())
