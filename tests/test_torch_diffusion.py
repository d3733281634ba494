"""Parity of the PyTorch port's Crank-Nicolson diffusion solver with
pyro2_tpu: the same problem set up by each package's own problem module,
stepped by each package's Pyro (JAX on the CPU in x64, the port on the CPU
in float64).  phi must agree to 1e-11 max|phi|: both sides run the same
float64 operations, apart from XLA's reciprocal in the smoother, and the
multigrid solve contracts roundoff differences rather than growing them.
"""

import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch import pyro_sim
from pyro2_tpu_torch.multigrid import MG, mg_kernel


def _pair(problem, inputs):
    pj = JPyro("diffusion")
    pj.initialize_problem(problem, inputs_dict=inputs)
    pt = Pyro("diffusion", device="cpu")
    pt.initialize_problem(problem, inputs_dict=inputs)
    return pj, pt


@pytest.mark.parametrize("bcs", ["neumann", "periodic", "dirichlet"])
def test_gaussian_matches_jax(bcs):
    inputs = {"mesh.nx": 64, "mesh.ny": 64}
    for edge in ("xl", "xr", "yl", "yr"):
        inputs[f"mesh.{edge}boundary"] = bcs
    pj, pt = _pair("gaussian", inputs)
    assert pt.sim.cc_data.data.dtype == torch.float64
    before = dict(mg_kernel.launches)
    for _ in range(5):
        pj.single_step()
        pt.single_step()
        assert pt.sim.dt == pj.sim.dt
    a = np.asarray(pj.get_var("phi"))
    b = pt.get_var("phi").numpy()
    assert np.abs(a - b).max() <= 1e-11 * np.abs(a).max()
    assert pt.sim.n == 5 and pt.sim.cc_data.t == pj.sim.cc_data.t
    # the CPU runs the plain versions: no kernel launch
    assert mg_kernel.launches == before


def test_each_step_solves_once():
    _, pt = _pair("gaussian", {"mesh.nx": 32, "mesh.ny": 32})
    before = dict(MG.stats)
    for _ in range(3):
        pt.single_step()
    assert MG.stats["solves"] == before["solves"] + 3
    assert MG.stats["cycles"] > before["cycles"]


def test_uniform_state_stays_uniform():
    pt = Pyro("diffusion", device="cpu")
    pt.initialize_problem("test", inputs_file="inputs.gaussian",
                          inputs_dict={"mesh.nx": 16, "mesh.ny": 16})
    for _ in range(3):
        pt.single_step()
    phi = pt.get_var("phi")
    g = pt.get_grid()
    assert torch.allclose(phi[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1],
                          torch.ones(16, 16, dtype=torch.float64),
                          rtol=0, atol=1e-12)


def test_cli_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    pyro_sim.main(["--device", "cpu", "diffusion", "gaussian",
                   "inputs.gaussian", "io.do_io=0", "mesh.nx=16",
                   "mesh.ny=16", "driver.max_steps=2"])
    assert "    2 " in capsys.readouterr().out


def test_rejects_grids_multigrid_cannot_take():
    pt = Pyro("diffusion", device="cpu")
    with pytest.raises(RuntimeError, match="power of 2"):
        pt.initialize_problem("gaussian", inputs_dict={"mesh.nx": 24,
                                                       "mesh.ny": 24})
