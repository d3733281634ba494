"""Face-centred data of the PyTorch port (mesh/patch.py FaceCenterData2d,
mesh/indexer.py aifc, _edge_fill_fc and fill_ghost_fc) against the JAX
package's, bit for bit on the CPU in float64: the storage shapes, the
periodic ghost fill of every edge for idir 1 and 2 (one ghost and two),
every shifted and buffered view, the norm, and the refusals (a
non-periodic edge, a custom BC, derived variables, the transfers); the
written file holds what the JAX package's holds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro2_tpu.mesh.boundary as jbnd
import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu.mesh import indexer as jindexer
from pyro2_tpu.mesh import patch as jpatch
from pyro2_tpu.mesh.grid import Grid2d as JGrid2d
from pyro2_tpu_torch.mesh import indexer, patch
from pyro2_tpu_torch.mesh.grid import Grid2d

PERIODIC = dict(xlb="periodic", xrb="periodic", ylb="periodic",
                yrb="periodic")
EDGES = ("xlb", "xrb", "ylb", "yrb")


def _grids(nx, ny, ng):
    return Grid2d(nx, ny, ng=ng), JGrid2d(nx, ny, ng=ng)


def _data(idir, nx=4, ny=6, ng=2, seed=100):
    """Both packages' FaceCenterData2d with one periodic variable "a" set
    to the same random values (ghosts included)."""
    g, jg = _grids(nx, ny, ng)
    d = patch.FaceCenterData2d(g, idir, device="cpu", dtype=torch.float64)
    jd = jpatch.FaceCenterData2d(jg, idir)
    d.register_var("a", bnd.BC(**PERIODIC))
    jd.register_var("a", jbnd.BC(**PERIODIC))
    d.create()
    jd.create()
    shape = (g.qx + 1, g.qy) if idir == 1 else (g.qx, g.qy + 1)
    a0 = np.random.default_rng(seed).random(shape)
    d.set_var("a", a0)
    jd.set_var("a", a0)
    return d, jd, a0


@pytest.mark.parametrize("idir", [1, 2])
@pytest.mark.parametrize("ng", [1, 2])
def test_fill_bc_equals_jax_bitwise(idir, ng):
    d, jd, a0 = _data(idir, ng=ng)
    assert tuple(d.data.shape) == tuple(jd.data.shape) == (1,) + a0.shape
    d.fill_BC("a")
    jd.fill_BC("a")
    got, ref = d.get_var("a").numpy(), np.asarray(jd.get_var("a"))
    assert np.array_equal(got, ref)
    assert not np.array_equal(got, a0)          # the ghosts changed


@pytest.mark.parametrize("idir", [1, 2])
@pytest.mark.parametrize("edge", range(4))
def test_each_edge_fill_equals_jax_bitwise(idir, edge):
    """_edge_fill_fc of one edge (axis and side) on a stack of two
    variables, in place in the port, returned by the JAX package."""
    g, jg = _grids(5, 3, 2)
    shape = (2, g.qx + 1, g.qy) if idir == 1 else (2, g.qx, g.qy + 1)
    a0 = np.random.default_rng(7 + edge).random(shape)
    axis, side = (-2, -1)[edge // 2], edge % 2
    a = torch.tensor(a0)
    out = indexer._edge_fill_fc(a, g, axis, side, "periodic", idir)
    ref = jindexer._edge_fill_fc(jnp.asarray(a0), jg, axis, side,
                                 "periodic", idir)
    assert out is a
    assert np.array_equal(a.numpy(), np.asarray(ref))
    assert not np.array_equal(a.numpy(), a0)
    with pytest.raises(NotImplementedError, match="face-centered"):
        indexer._edge_fill_fc(a, g, axis, side, "outflow", idir)


@pytest.mark.parametrize("idir", [1, 2])
def test_views_and_norm_equal_jax(idir):
    d, jd, _ = _data(idir)
    d.fill_BC("a")
    jd.fill_BC("a")
    av, jav = d.get_ai("a"), jd.get_ai("a")
    assert isinstance(av, indexer.aifc) and av.idir == idir
    for view in (lambda x: x.v(), lambda x: x.v(buf=1),
                 lambda x: x.ip(1), lambda x: x.ip(-1, buf=1),
                 lambda x: x.jp(1), lambda x: x.ip_jp(1, -1),
                 lambda x: x.v(buf=(1, 0, 0, 1))):
        assert np.array_equal(view(av).numpy(), np.asarray(view(jav)))
    assert float(av.norm()) == float(jav.norm())
    n = 5 if idir == 1 else 4
    assert tuple(av.v().shape) == ((n, 6) if idir == 1 else (4, 7))
    with pytest.raises(NotImplementedError, match="lap"):
        av.lap()
    assert d.min("a") == jd.min("a") and d.max("a") == jd.max("a")


def test_fill_ghost_fc_in_place_and_on_the_data_device():
    g, jg = _grids(4, 4, 1)
    a0 = np.random.default_rng(3).random((g.qx + 1, g.qy))
    a = torch.tensor(a0)
    assert indexer.fill_ghost_fc(a, g, bnd.BC(**PERIODIC), 1) is a
    assert np.array_equal(a.numpy(), np.asarray(jindexer.fill_ghost_fc(
        jnp.asarray(a0), jg, jbnd.BC(**PERIODIC), 1)))
    d = patch.FaceCenterData2d(g, 2, device="cpu")
    d.register_var("a", bnd.BC(**PERIODIC))
    d.create()
    assert d.data.device.type == "cpu" and d.data.dtype == torch.float64


def test_refusals_match_jax():
    g, jg = _grids(4, 4, 1)
    for mod, grid, b, kw in ((patch, g, bnd, {"device": "cpu"}),
                             (jpatch, jg, jbnd, {})):
        d = mod.FaceCenterData2d(grid, 1, **kw)
        with pytest.raises(NotImplementedError, match="derived"):
            d.add_derived(lambda *a: None)
        d.register_var("a", b.BC(xlb="outflow", xrb="outflow",
                                 ylb="periodic", yrb="periodic"))
        d.create()
        with pytest.raises(RuntimeError, match="already initialized"):
            d.create()
        with pytest.raises(NotImplementedError, match="outflow"):
            d.fill_BC("a")
        with pytest.raises(NotImplementedError, match="restriction"):
            d.restrict("a")
        with pytest.raises(NotImplementedError, match="prolongation"):
            d.prolong("a")


def test_custom_bc_refused():
    saved = [(m.bc_solid.copy(), m.ext_bcs.copy()) for m in (jbnd, bnd)]
    try:
        g, jg = _grids(4, 4, 1)
        for mod, grid, b, kw in ((patch, g, bnd, {"device": "cpu"}),
                                 (jpatch, jg, jbnd, {})):
            b.define_bc("fc_test", lambda *a: None, is_solid=False)
            d = mod.FaceCenterData2d(grid, 2, **kw)
            d.register_var("a", b.BC(xlb="periodic", xrb="periodic",
                                     ylb="fc_test", yrb="fc_test"))
            d.create()
            with pytest.raises(NotImplementedError, match="custom BCs"):
                d.fill_BC("a")
    finally:
        for m, (solid, ext) in zip((jbnd, bnd), saved):
            m.bc_solid.clear()
            m.bc_solid.update(solid)
            m.ext_bcs.clear()
            m.ext_bcs.update(ext)


def test_write_data_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    from pyro2_tpu_torch.util import hdf5

    d, jd, _ = _data(1)
    d.fill_BC("a")
    jd.fill_BC("a")
    with hdf5.File(str(tmp_path / "port.h5"), "w") as f:
        d.write_data(f)
    with h5py.File(str(tmp_path / "jax.h5"), "w") as f:
        jd.write_data(f)
    with h5py.File(str(tmp_path / "port.h5"), "r") as p, \
            h5py.File(str(tmp_path / "jax.h5"), "r") as j:
        a, b = p["face-centered-state/a"], j["face-centered-state/a"]
        assert np.array_equal(a["data"][...], b["data"][...])
        assert a["data"].shape == (5, 6)
        for edge in EDGES:
            assert a.attrs[edge[:2] + "b"] == b.attrs[edge[:2] + "b"]
