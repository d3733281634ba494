"""Parity of the PyTorch port's ShardedDiffusion (pyro2_tpu_torch/parallel/
sharded_diffusion.py) with pyro2_tpu's, and with the port's serial
diffusion solver.

The gaussian problem at 32^2 with Neumann edges (as tests/test_parallel.py
TestShardedDiffusion), 3 steps, on a 2x2 mesh of gloo ranks and on a 1x1
mesh in this process, against the JAX package's ShardedDiffusion on the same
mesh shape (conftest's fake CPU devices) and against the port's serial
diffusion Simulation.  phi must agree to 1e-12 max|phi|: every solve runs
the same float64 operations up to the order of the norms' sums and XLA's
reciprocal in the smoother, and the multigrid contracts such differences.
"""

import importlib

import numpy as np
import pytest
import torch

import torch_rank_programs as trp
from pyro2_tpu.parallel import make_mesh as jmake_mesh
from pyro2_tpu.parallel.sharded_diffusion import \
    ShardedDiffusion as JShardedDiffusion
from pyro2_tpu.util.runparams import RuntimeParameters as JRP
from pyro2_tpu_torch.multigrid import MG
from pyro2_tpu_torch.parallel import ShardedDiffusion, launch, make_mesh
from pyro2_tpu_torch.parallel import sharded_mg
from pyro2_tpu_torch.util.runparams import RuntimeParameters

STEPS = 3


def _rp(cls):
    pkg = "pyro2_tpu_torch" if cls is RuntimeParameters else "pyro2_tpu"
    problem = importlib.import_module(
        f"{pkg}.solvers.diffusion.problems.gaussian")
    rp = cls()
    rp.load_params(f"{pkg}/_defaults")
    rp.load_params(f"{pkg}/solvers/diffusion/_defaults")
    for k, v in problem.PROBLEM_PARAMS.items():
        rp.set_param(k, v, no_new=False)
    for k, v in {"mesh.nx": 32, "mesh.ny": 32,
                 "mesh.xlboundary": "neumann", "mesh.xrboundary": "neumann",
                 "mesh.ylboundary": "neumann", "mesh.yrboundary": "neumann",
                 "driver.verbose": 0, "vis.dovis": 0,
                 "io.do_io": 0}.items():
        rp.set_param(k, v, no_new=False)
    return rp


@pytest.fixture(scope="module")
def serial():
    """The port's serial diffusion after STEPS steps: (phi interior, cycles
    of each solve)."""
    from pyro2_tpu_torch.solvers import diffusion
    from pyro2_tpu_torch.solvers.diffusion.problems import gaussian

    sim = diffusion.Simulation("diffusion", "gaussian", gaussian.init_data,
                               _rp(RuntimeParameters), device="cpu")
    sim.initialize()
    sim.method_compute_timestep()
    cycles = []
    for _ in range(STEPS):
        before = MG.stats["cycles"]
        sim.evolve()
        cycles.append(MG.stats["cycles"] - before)
    g = sim.cc_data.grid
    return sim.cc_data.get_var("phi")[g.ilo:g.ihi + 1,
                                      g.jlo:g.jhi + 1].numpy(), cycles


def _jax_phi(shape):
    sd = JShardedDiffusion(_rp(JRP), jmake_mesh(shape=shape),
                           problem="gaussian")
    for _ in range(STEPS):
        sd.evolve()
    return np.asarray(sd.get_phi())


def _close(ref, got, tol=1e-12):
    assert np.abs(ref - got).max() <= tol * np.abs(ref).max()


def test_one_block_matches_jax_and_serial(serial):
    ref, cycles = serial
    sd = ShardedDiffusion(_rp(RuntimeParameters), make_mesh(device="cpu"))
    assert sd.smg.use_pallas                # the kernel structure
    got = []
    for _ in range(STEPS):
        sd.evolve()
        got.append(sd.smg.num_cycles)
    assert got == cycles and sd.n == STEPS
    phi = sd.get_phi().numpy()
    _close(ref, phi)
    _close(_jax_phi((1, 1)), phi)
    np.testing.assert_array_equal(sd.gather_phi().numpy(), phi)


def test_2x2_mesh_matches_jax_and_serial(serial):
    ref, cycles = serial
    out = launch.run(trp.diffusion, (2, 2), _rp(RuntimeParameters).params,
                     STEPS, device="cpu", timeout=240)
    phi = out[0]["gathered"]
    for r, res in enumerate(out):
        assert res["cycles"] == cycles
        ix, iy = divmod(r, 2)
        np.testing.assert_array_equal(
            res["block"], phi[ix * 16:(ix + 1) * 16, iy * 16:(iy + 1) * 16])
    _close(ref, phi)
    _close(_jax_phi((2, 2)), phi)


def test_each_step_resets_the_operator(monkeypatch):
    # evolve sets alpha and beta before every solve; a dt changed between
    # steps takes effect at once
    sd = ShardedDiffusion(_rp(RuntimeParameters), make_mesh(device="cpu"))
    sd.evolve()
    sd.dt *= 0.5
    solves = sharded_mg.stats["solves"]
    sd.evolve()
    assert sharded_mg.stats["solves"] == solves + 1
    assert sd.smg.serial.beta == 0.5 * sd.dt * sd.k
    assert sd.smg.serial.alpha == 1.0
    assert torch.isfinite(sd.get_phi()).all()
