"""The port's tracer particles against pyro2_tpu's, on the CPU in float64.

The six tests of tests/test_particles.py, each also holding the port's
`Particles` to the JAX package's on the same numpy inputs (positions at
rtol 1e-12, `active` equal), the random generator's positions from one
numpy seed, the pure advance on a sheared field, and a file with
particles written and read back equal by bits in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro2_tpu.mesh.boundary as jbnd
import pyro2_tpu.util.io_pyro as jio
import pyro2_tpu_torch.mesh.boundary as tbnd
from pyro2_tpu.mesh import patch as jpatch
from pyro2_tpu.mesh.grid import Grid2d as JGrid
from pyro2_tpu.particles.particles import Particles as JParticles
from pyro2_tpu.pyro_sim import Pyro as JPyro
from pyro2_tpu_torch import Pyro as TPyro
from pyro2_tpu_torch.mesh import patch as tpatch
from pyro2_tpu_torch.mesh.grid import Grid2d as TGrid
from pyro2_tpu_torch.particles import Particles as TParticles
from pyro2_tpu_torch.util import io_pyro

RTOL = 1e-12


def _data(nx=16, bc_type="periodic"):
    """(port data, port bc, JAX data, JAX bc, grid) with one variable."""
    out = []
    for Grid, patch, bnd, kw in ((TGrid, tpatch, tbnd, {"device": "cpu"}),
                                 (JGrid, jpatch, jbnd, {})):
        g = Grid(nx, nx, ng=4)
        d = patch.CellCenterData2d(g, **kw)
        bc = bnd.BC(xlb=bc_type, xrb=bc_type, ylb=bc_type, yrb=bc_type)
        d.register_var("density", bc)
        d.create()
        out += [d, bc]
    return (*out, g)


def _pair(bc_type, n, gen, **kw):
    td, tbc, jd, jbc, g = _data(bc_type=bc_type)
    return (TParticles(td, tbc, n, gen, **kw),
            JParticles(jd, jbc, n, gen, **kw), g)


def _agree(tp, jp):
    """Positions at rtol 1e-12, `active` equal, the accessors equal."""
    np.testing.assert_allclose(tp.positions.numpy(),
                               np.asarray(jp.positions), rtol=RTOL)
    assert np.array_equal(tp.active.numpy(), np.asarray(jp.active))
    np.testing.assert_allclose(tp.get_positions(), jp.get_positions(),
                               rtol=RTOL)
    np.testing.assert_array_equal(tp.get_init_positions(),
                                  jp.get_init_positions())


def _uniform(g, u, v):
    return (torch.full((g.qx, g.qy), u, dtype=torch.float64),
            torch.full((g.qx, g.qy), v, dtype=torch.float64),
            jnp.full((g.qx, g.qy), u), jnp.full((g.qx, g.qy), v))


class TestGenerators:
    def test_grid_generator(self):
        tp, jp, g = _pair("periodic", 16, "grid")
        pos = tp.get_positions()
        assert pos.shape == (16, 2)
        assert (pos[:, 0] >= g.xmin).all() and (pos[:, 0] <= g.xmax).all()
        assert tp.positions.dtype == torch.float64
        assert tp.active.dtype == torch.bool
        _agree(tp, jp)

    def test_array_generator(self):
        arr = np.array([[0.25, 0.25], [0.5, 0.75]])
        tp, jp, _ = _pair("periodic", 2, "array", pos_array=arr)
        np.testing.assert_array_equal(tp.get_positions(), arr)
        np.testing.assert_array_equal(tp.get_init_positions(), arr)
        _agree(tp, jp)

    def test_random_generator_draws_numpy_global_rng(self):
        np.random.seed(7)
        td, tbc, jd, jbc, _ = _data()
        tp = TParticles(td, tbc, 50, "random")
        np.random.seed(7)
        jp = JParticles(jd, jbc, 50, "random")
        assert np.array_equal(tp.positions.numpy(), np.asarray(jp.positions))

    def test_rp_in_place_of_the_count(self):
        """The compressible solver hands its RuntimeParameters over."""
        p = TPyro("compressible", device="cpu")
        p.initialize_problem("sod", inputs_dict={
            "mesh.nx": 16, "mesh.ny": 8, "particles.do_particles": 1,
            "particles.n_particles": 9,
            "particles.particle_generator": "grid"})
        assert p.sim.particles.positions.shape == (9, 2)


class TestAdvection:
    def test_constant_velocity(self):
        """With constant (u, v), particles translate exactly."""
        tp, jp, g = _pair("periodic", 4, "grid")
        p0 = tp.get_positions().copy()
        tu, tv, ju, jv = _uniform(g, 0.5, -0.25)
        dt = 0.1
        tp.update_particles(dt, tu, tv)
        jp.update_particles(dt, ju, jv)
        expected = p0 + dt * np.array([0.5, -0.25])
        expected[:, 0] = np.where(expected[:, 0] > g.xmax,
                                  g.xmin + expected[:, 0] - g.xmax,
                                  expected[:, 0])
        np.testing.assert_allclose(tp.get_positions(), expected, rtol=RTOL)
        _agree(tp, jp)

    def test_outflow_deletes(self):
        arr = np.array([[0.95, 0.5], [0.5, 0.5]])
        tp, jp, g = _pair("outflow", 2, "array", pos_array=arr)
        tu, tv, ju, jv = _uniform(g, 1.0, 0.0)
        tp.update_particles(0.1, tu, tv)   # the first exits at x > 1
        jp.update_particles(0.1, ju, jv)
        assert len(tp.get_positions()) == 1
        # inactive, not deleted: the row stays where it went
        assert tp.positions.shape == (2, 2)
        _agree(tp, jp)

    def test_reflect_bounces(self):
        arr = np.array([[0.97, 0.5]])
        tp, jp, g = _pair("reflect-even", 1, "array", pos_array=arr)
        tu, tv, ju, jv = _uniform(g, 1.0, 0.0)
        tp.update_particles(0.1, tu, tv)
        jp.update_particles(0.1, ju, jv)
        pos = tp.get_positions()
        assert len(pos) == 1
        # reflected: 0.97 + 0.1 = 1.07 -> 2*1.0 - 1.07 = 0.93
        np.testing.assert_allclose(pos[0, 0], 0.93, rtol=RTOL)
        _agree(tp, jp)

    @pytest.mark.parametrize("bc_type", ["periodic", "outflow",
                                         "reflect-even", "dirichlet"])
    def test_sheared_field_and_edges(self, bc_type):
        """A non-uniform field (the bilinear weights and the trunc + 1
        index clipped to the window), positions on both sides of every
        edge, and a tensor dt."""
        rng = np.random.default_rng(3)
        arr = rng.uniform(-0.1, 1.1, size=(64, 2))
        tp, jp, g = _pair(bc_type, 64, "array", pos_array=arr)
        u = rng.normal(size=(g.qx, g.qy))
        v = rng.normal(size=(g.qx, g.qy))
        for dt in (0.07, 0.05):
            tp.update_particles(torch.tensor(dt, dtype=torch.float64),
                                torch.as_tensor(u), torch.as_tensor(v))
            jp.update_particles(dt, jnp.asarray(u), jnp.asarray(v))
            _agree(tp, jp)


class TestIO:
    def test_write_particles(self, tmp_path):
        import h5py
        tp, jp, _ = _pair("periodic", 4, "grid")
        fn = str(tmp_path / "p.h5")
        with h5py.File(fn, "w") as f:
            tp.write_particles(f)
        with h5py.File(fn, "r") as f:
            assert f["particles"]["particle_positions"].shape == (4, 2)
            assert f["particles"]["particle_positions"].dtype == np.float64
            np.testing.assert_array_equal(
                f["particles"]["init_particle_positions"][...],
                jp.get_init_positions())

    def test_written_particles_read_back_by_bits(self, tmp_path):
        """A port file with particles, some inactive, reads back equal by
        bits through both packages' read, and so does the JAX package's
        file of the same run (advection has no custom BC to register)."""
        def run(P, **kw):
            np.random.seed(11)
            p = P("advection", **kw)
            p.initialize_problem("smooth", inputs_dict={
                "mesh.nx": 16, "mesh.ny": 16, "mesh.xlboundary": "outflow",
                "mesh.xrboundary": "outflow",
                "particles.do_particles": 1,
                "particles.particle_generator": "random",
                "particles.n_particles": 40})
            for _ in range(3):
                p.single_step()
            return p

        t = run(TPyro, device="cpu")
        j = run(JPyro)
        assert 0 < int(t.sim.particles.active.sum()) < 40
        tfn, jfn = str(tmp_path / "t"), str(tmp_path / "j")
        t.sim.write(tfn)
        j.sim.write(jfn)
        for fn in (tfn, jfn):
            ts = io_pyro.read(fn, device="cpu")
            js = jio.read(fn)
            for got in (ts.particles.positions.numpy(),
                        np.asarray(js.particles.positions)):
                assert np.array_equal(got, t.sim.particles.get_positions())
            assert np.array_equal(ts.particles.init_positions.numpy(),
                                  t.sim.particles.get_init_positions())
            assert ts.particles.bc is None
            assert bool(ts.particles.active.all())
