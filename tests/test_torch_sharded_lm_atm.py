"""Parity of the port's sharded low-Mach solver (pyro2_tpu_torch/parallel/
sharded_lm_atm.py) with the port's serial lm_atm, with itself across
meshes and with pyro2_tpu, and of ShardedVarCoeffMG.install_coefficients
with a fresh construction.

The case is JAX's TestShardedLMAtm.CFG (bubble 16^2, periodic x, reflect
and outflow y): the preevolve and 3 steps in float64, on gloo ranks of a
2x2 and a 1x4 mesh (one launch each: torch_rank_programs.sharded_lm_atm)
and on the 1x1 mesh in this process.

Tolerances:
* 2x2 and 1x4 against 1x1: 1e-11 of max(1, max|U|) (the solves sum their
  norms over the ranks, which may round apart), equal step counts and
  dts.  Measured: equal by bits.
* 1x1 against the port's serial Simulation: bits (one block sums its
  norms as the serial solve does).
* the port against JAX's ShardedLMAtm on 1 and 8 of conftest's fake CPU
  devices and JAX's serial solver: JAX's own rtol 1e-9 / atol 1e-10, and
  1e-13 of max(1, max|U|).  Measured: 7.1e-15 (2.9e-16 of max|U| = 24.8);
  XLA fuses the jitted phases and may contract a multiply and an add where
  torch rounds each.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import torch_rank_programs as trp

from pyro2_tpu.util.runparams import RuntimeParameters as JRP
from pyro2_tpu_torch.mesh.boundary import BC
from pyro2_tpu_torch.parallel import ShardedLMAtm, ShardedVarCoeffMG, launch
from pyro2_tpu_torch.parallel.mesh_comm import Mesh
from pyro2_tpu_torch.util.runparams import RuntimeParameters

CFG = {"mesh.nx": 16, "mesh.ny": 16, "mesh.xmax": 1.0, "mesh.ymax": 1.0,
       "mesh.xlboundary": "periodic", "mesh.xrboundary": "periodic",
       "mesh.ylboundary": "reflect", "mesh.yrboundary": "outflow",
       "bubble.x_pert": 0.5, "bubble.y_pert": 0.35, "bubble.r_pert": 0.15,
       "bubble.scale_height": 1.0, "driver.verbose": 0, "vis.dovis": 0,
       "io.do_io": 0}
STEPS = 3
F64 = torch.float64


def _params(pkg, **extra):
    rp = (RuntimeParameters if pkg == "pyro2_tpu_torch" else JRP)()
    rp.load_params(f"{pkg}/_defaults")
    rp.load_params(f"{pkg}/solvers/lm_atm/_defaults")
    pm = importlib.import_module(f"{pkg}.solvers.lm_atm.problems.bubble")
    for k, v in {**pm.PROBLEM_PARAMS, **CFG, **extra}.items():
        rp.set_param(k, v, no_new=False)
    return rp


def _interior(sim):
    g = sim.cc_data.grid
    return np.array(sim.cc_data.data[:, g.ilo:g.ihi + 1, g.jlo:g.jhi + 1])


def _serial_run(pkg):
    """A serial lm_atm run stepped as Pyro's loop steps it: (final
    interior, dts)."""
    mod = importlib.import_module(f"{pkg}.solvers.lm_atm")
    pm = importlib.import_module(f"{pkg}.solvers.lm_atm.problems.bubble")
    kw = {"device": "cpu"} if pkg == "pyro2_tpu_torch" else {}
    sim = mod.Simulation("lm_atm", "bubble", pm.init_data, _params(pkg),
                         **kw)
    sim.initialize()
    sim.cc_data.fill_BC_all()
    sim.preevolve()
    dts = []
    for _ in range(STEPS):
        sim.cc_data.fill_BC_all()
        sim.method_compute_timestep()
        dts.append(float(sim.dt))
        sim.evolve()
    return _interior(sim), dts


@functools.lru_cache(maxsize=None)
def _serial():
    return _serial_run("pyro2_tpu_torch")


@functools.lru_cache(maxsize=None)
def _jax_sharded(ndev):
    from pyro2_tpu.parallel import make_mesh as jmake_mesh
    from pyro2_tpu.parallel.sharded_lm_atm import \
        ShardedLMAtm as JShardedLMAtm

    s = JShardedLMAtm(_params("pyro2_tpu"), jmake_mesh(ndev),
                      problem="bubble")
    s.preevolve()
    for _ in range(STEPS):
        s.method_compute_timestep()
        s.evolve()
    return np.asarray(s.U_int)


@pytest.fixture(scope="module")
def runs():
    """{mesh shape: rank 0's result}; every rank's gathered state and dts
    checked equal to rank 0's."""
    params = _params("pyro2_tpu_torch").params
    out = {(1, 1): launch.to_host(trp.sharded_lm_atm(
        launch.make_mesh(device="cpu"), params, STEPS))}
    for shape in ((2, 2), (1, 4)):
        ranks = launch.run(trp.sharded_lm_atm, shape, params, STEPS,
                           device="cpu", timeout=300)
        for res in ranks[1:]:
            np.testing.assert_array_equal(res["U"], ranks[0]["U"])
            assert res["dts"] == ranks[0]["dts"]
        out[shape] = ranks[0]
    return out


class TestShardedLMAtm:
    @pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
    def test_partition_invariance(self, runs, shape):
        """N ranks against 1: 1e-11 of max(1, max|U|), equal n and dts.
        Fails if the corrected MAC faces' seam exchange is dropped (the
        rho and state stages then read uncorrected seam faces) or a seam's
        coefficient takes the physical fill."""
        ref, got = runs[(1, 1)], runs[shape]
        assert got["n"] == ref["n"] == STEPS
        assert got["dts"] == ref["dts"] and got["t"] == ref["t"]
        scale = max(1.0, np.abs(ref["U"]).max())
        assert np.abs(got["U"] - ref["U"]).max() <= 1e-11 * scale
        assert np.abs(got["U_pre"] - ref["U_pre"]).max() <= 1e-11 * scale

    def test_one_rank_is_the_serial_run(self, runs):
        """The 1x1 mesh gives the port's serial Simulation's bits and dts
        (and moves the state).  Fails if a projection keeps the previous
        coefficients or a time-centred term takes the wrong density."""
        U, dts = _serial()
        np.testing.assert_array_equal(runs[(1, 1)]["U"], U)
        assert runs[(1, 1)]["dts"] == dts
        assert runs[(1, 1)]["t"] == sum(dts)
        assert np.isfinite(U).all()
        assert np.abs(U[1:3]).max() > 1e-3     # the bubble rises

    @pytest.mark.parametrize("ndev", [1, 8])
    def test_matches_jax_sharded(self, runs, ndev):
        """The port on a 1x1 and a 2x2 mesh against JAX's ShardedLMAtm on
        ndev fake devices."""
        ref = _jax_sharded(ndev)
        for shape in ((1, 1), (2, 2)):
            got = runs[shape]["U"]
            np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-10)
            assert np.abs(got - ref).max() <= \
                1e-13 * max(1.0, np.abs(ref).max())

    def test_matches_jax_serial(self, runs):
        """The port's 2x2 run against JAX's serial lm_atm (JAX's own
        test_matches_serial tolerance, and 1e-13 of max(1, max|U|))."""
        ref, dts = _serial_run("pyro2_tpu")
        got = runs[(2, 2)]
        np.testing.assert_allclose(got["U"], ref, rtol=1e-9, atol=1e-10)
        assert np.abs(got["U"] - ref).max() <= \
            1e-13 * max(1.0, np.abs(ref).max())
        np.testing.assert_allclose(got["dts"], dts, rtol=1e-12)

    def test_dt_is_the_serial_dt(self):
        """method_compute_timestep: the serial rule through Mesh.pmax."""
        from pyro2_tpu_torch.solvers import lm_atm
        from pyro2_tpu_torch.solvers.lm_atm.problems import bubble

        s = ShardedLMAtm(_params("pyro2_tpu_torch"),
                         launch.make_mesh(device="cpu"), dtype=F64)
        sim = lm_atm.Simulation("lm_atm", "bubble", bubble.init_data,
                                _params("pyro2_tpu_torch"), device="cpu")
        sim.initialize()
        sim.cc_data.fill_BC_all()
        s.method_compute_timestep()
        sim.method_compute_timestep()
        assert s.dt == sim.dt

    def test_bc_refused(self):
        """A domain edge the path does not take is refused before anything
        is built, naming the sharded path (the serial construction would
        fail on phi's missing BC with another message)."""
        rp = _params("pyro2_tpu_torch", **{"mesh.ylboundary": "dirichlet"})
        with pytest.raises(ValueError, match="sharded lm_atm"):
            ShardedLMAtm(rp, launch.make_mesh(device="cpu"))

    def test_grid_must_divide(self):
        with pytest.raises(ValueError, match="divide"):
            ShardedLMAtm(_params("pyro2_tpu_torch"),
                         Mesh((3, 1), "cpu", (0, 0)))


def _eta(n, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(1.0 + rng.random((n, n)), dtype=F64)


def _levels_equal(a, b):
    """Every coefficient tensor of two ShardedVarCoeffMG equal by bits:
    the serial object's levels (planes, edge views, the cell-centred
    chain), the sharded levels' block frames and their one-ghost frames
    (the half-sweep entry's)."""
    sa, sb = a.serial, b.serial
    assert len(sa.planes) == len(sb.planes) == a.nlevels
    for k in range(a.nlevels):
        assert torch.equal(sa.planes[k], sb.planes[k]), k
        assert sa.planes[k].is_contiguous()
        assert torch.equal(sa.edge_coeffs[k].x, sb.edge_coeffs[k].x), k
        assert torch.equal(sa.edge_coeffs[k].y, sb.edge_coeffs[k].y), k
        assert sa.edge_coeffs[k].x.data_ptr() == sa.planes[k].data_ptr()
        assert torch.equal(sa.aux["coeffs"][k], sb.aux["coeffs"][k]), k
    assert a._planes.keys() == b._planes.keys()
    for k in a._planes:
        assert torch.equal(a._planes[k], b._planes[k]), k
        assert a._planes[k].is_contiguous()
        assert torch.equal(a._planes1[k], b._planes1[k]), k
        assert a._planes1[k].is_contiguous()


class TestInstallCoefficients:
    BC_PHI = ("periodic", "periodic", "neumann", "dirichlet")

    def _mg(self, n, mesh, eta, use_pallas):
        return ShardedVarCoeffMG(
            n, n, mesh, xl_BC_type=self.BC_PHI[0],
            xr_BC_type=self.BC_PHI[1], yl_BC_type=self.BC_PHI[2],
            yr_BC_type=self.BC_PHI[3], coeffs=eta,
            coeffs_bc=BC(xlb="periodic", xrb="periodic", ylb="reflect-even",
                         yrb="outflow"),
            use_pallas=use_pallas, dtype=F64)

    @pytest.mark.parametrize("n, shape, use_pallas", [
        (256, (1, 1), True), (256, (2, 2), True), (256, (1, 4), True),
        (64, (2, 2), False)])
    def test_equals_a_fresh_construction(self, n, shape, use_pallas):
        """After install_coefficients(eta2) every level of an object built
        with eta1 equals, bit for bit, an object built with eta2, at every
        block of the split: the replicated levels the coarse core reads
        (k < k_cross) as well as the sharded frames.  Fails if the install
        leaves the replicated levels (or the one-ghost views) stale."""
        eta1, eta2 = _eta(n, 1), _eta(n, 2)
        for ix in range(shape[0]):
            for iy in range(shape[1]):
                mesh = Mesh(shape, "cpu", (ix, iy))
                got = self._mg(n, mesh, eta1, use_pallas)
                assert 0 < got.k_cross < got.nlevels
                assert not torch.equal(got.serial.planes[0],
                                       self._mg(n, mesh, eta2,
                                                use_pallas).serial.planes[0])
                got.install_coefficients(eta2)
                _levels_equal(got, self._mg(n, mesh, eta2, use_pallas))

    def test_padded_eta_and_a_solve(self):
        """A padded eta installs as its interior, and a solve after the
        install takes the fresh object's cycles and bits."""
        n = 64
        mesh = Mesh((1, 1), "cpu", (0, 0))
        eta2 = _eta(n, 2)
        got = self._mg(n, mesh, _eta(n, 1), True)
        got.install_coefficients(torch.nn.functional.pad(eta2, (4,) * 4,
                                                         value=7.0))
        ref = self._mg(n, mesh, eta2, True)
        f = torch.as_tensor(np.random.default_rng(3).standard_normal(
            (n, n)), dtype=F64)
        for mg in (got, ref):
            mg.init_zeros()
            mg.init_RHS(f - f.mean())
            mg.solve(rtol=1e-10)
        assert got.num_cycles == ref.num_cycles > 1
        assert torch.equal(got.get_solution(), ref.get_solution())
