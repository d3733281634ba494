"""Parity of the port's mesh layer (grid, ghost fills, custom compressible
BCs) with pyro2_tpu.  The grids are copies, so coordinates must be equal;
the ghost fills are copies, so they must match exactly, or to 1e-15
relative where hse does arithmetic."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro2_tpu.mesh.boundary as jbnd
import pyro2_tpu_torch.mesh.boundary as tbnd
from pyro2_tpu.mesh.grid import Cartesian2d as JCartesian2d
from pyro2_tpu.mesh.grid import SphericalPolar as JSphericalPolar
from pyro2_tpu.mesh.indexer import fill_ghost as jfill
from pyro2_tpu.mesh.patch import CellCenterData2d as JData
from pyro2_tpu.solvers.compressible import BC as JBC
from pyro2_tpu_torch.mesh.grid import Cartesian2d, SphericalPolar
from pyro2_tpu_torch.mesh.indexer import ai, embed
from pyro2_tpu_torch.mesh.indexer import fill_ghost as tfill
from pyro2_tpu_torch.mesh.patch import CellCenterData2d as TData
from pyro2_tpu_torch.solvers.compressible import BC as TBC

GRID_ATTRS = ("xl", "xr", "x", "yl", "yr", "y", "x2d", "y2d", "Lx", "Ly",
              "Ax", "Ay", "dlogAx", "dlogAy", "V")


@pytest.mark.parametrize("kind", ["cart", "sph"])
def test_grid_coordinates_equal(kind):
    if kind == "cart":
        a = JCartesian2d(20, 36, ng=4, xmin=0.1, xmax=1.3, ymax=3.0)
        b = Cartesian2d(20, 36, ng=4, xmin=0.1, xmax=1.3, ymax=3.0)
    else:
        kw = dict(ng=4, xmin=0.5, xmax=1.0, ymin=0.7, ymax=2.3)
        a = JSphericalPolar(20, 36, **kw)
        b = SphericalPolar(20, 36, **kw)
    for att in ("nx", "ny", "ng", "qx", "qy", "ilo", "ihi", "jlo", "jhi",
                "dx", "dy"):
        assert getattr(a, att) == getattr(b, att)
    for att in GRID_ATTRS:
        np.testing.assert_array_equal(getattr(b, att), getattr(a, att))


def _bc_pair(kind_x, kind_y, odd=""):
    kw = dict(xlb=kind_x, xrb=kind_x, ylb=kind_y, yrb=kind_y,
              odd_reflect_dir=odd)
    return jbnd.BC(**kw), tbnd.BC(**kw)


@pytest.mark.parametrize("kinds", [
    ("outflow", "outflow", ""), ("periodic", "periodic", ""),
    ("reflect", "reflect", ""), ("reflect", "reflect", "x"),
    ("reflect", "reflect", "y"), ("periodic", "outflow", "y"),
    ("outflow", "reflect", "y")])
@pytest.mark.parametrize("nx,ny", [(32, 24), (20, 36)])
def test_fill_ghost_matches_jax(kinds, nx, ny):
    rng = np.random.default_rng(nx * ny)
    jg = JCartesian2d(nx, ny, ng=4)
    tg = Cartesian2d(nx, ny, ng=4)
    a = rng.standard_normal((3, tg.qx, tg.qy))
    jbc, tbc = _bc_pair(*kinds)
    want = np.asarray(jfill(jnp.asarray(a), jg, jbc))
    got = tfill(torch.as_tensor(a.copy()), tg, tbc).numpy()
    np.testing.assert_array_equal(got, want)


def test_fill_ghost_inhomogeneous_matches_jax():
    rng = np.random.default_rng(1)
    jg = JCartesian2d(20, 36, ng=4)
    tg = Cartesian2d(20, 36, ng=4)
    a = rng.standard_normal((tg.qx, tg.qy))
    kw = dict(xlb="dirichlet", xrb="neumann", ylb="neumann",
              yrb="dirichlet", xl_func=np.sin, xr_func=np.cos,
              yl_func=lambda x: x ** 2, yr_func=np.exp)
    jbc = jbnd.BC(grid=jg, **kw)
    tbc = tbnd.BC(grid=tg, **kw)
    want = np.asarray(jfill(jnp.asarray(a), jg, jbc))
    got = tfill(torch.as_tensor(a.copy()), tg, tbc).numpy()
    np.testing.assert_array_equal(got, want)


def _containers(bcname_x, bcname_y, nx=20, ny=36, t=0.0):
    """The same compressible-style container in both packages, with the
    custom BCs registered and a random positive state."""
    jbnd.define_bc("hse", JBC.user, is_solid=False)
    jbnd.define_bc("ambient", JBC.user, is_solid=False)
    jbnd.define_bc("ramp", JBC.user, is_solid=False)
    tbnd.define_bc("hse", TBC.user, is_solid=False)
    tbnd.define_bc("ambient", TBC.user, is_solid=False)
    tbnd.define_bc("ramp", TBC.user, is_solid=False)
    rng = np.random.default_rng(11)
    out = []
    for bnd, grid, data in ((jbnd, JCartesian2d, JData),
                            (tbnd, Cartesian2d, TData)):
        g = grid(nx, ny, ng=4)
        kw = dict(xlb=bcname_x[0], xrb=bcname_x[1], ylb=bcname_y[0],
                  yrb=bcname_y[1])
        bc = bnd.BC(**kw)
        bc_x = bnd.BC(odd_reflect_dir="x", **kw)
        bc_y = bnd.BC(odd_reflect_dir="y", **kw)
        d = data(g) if data is JData else data(g, dtype=torch.float64,
                                                device="cpu")
        d.register_var("density", bc)
        d.register_var("energy", bc)
        d.register_var("x-momentum", bc_x)
        d.register_var("y-momentum", bc_y)
        for k, v in (("gamma", 1.4), ("grav", -1.0), ("ambient_rho", 0.3),
                     ("ambient_u", 0.2), ("ambient_v", -0.1),
                     ("ambient_p", 2.0)):
            d.set_aux(k, v)
        d.create()
        d.t = t
        out.append(d)
    shape = (out[0].grid.qx, out[0].grid.qy)
    rho = 1.0 + rng.random(shape)
    vals = {"density": rho, "energy": 5.0 + rng.random(shape),
            "x-momentum": rho * rng.standard_normal(shape),
            "y-momentum": rho * rng.standard_normal(shape)}
    for d in out:
        for k, v in vals.items():
            d.set_var(k, v)
    return out


@pytest.mark.parametrize("bcs", [
    (("periodic", "periodic"), ("hse", "hse")),
    (("outflow", "outflow"), ("reflect", "ambient")),
    (("ramp", "outflow"), ("ramp", "ramp"))])
def test_custom_bcs_match_jax(bcs):
    jd, td = _containers(*bcs, t=0.013)
    jd.fill_BC_all()
    td.fill_BC_all()
    want = np.asarray(jd.data)
    got = td.data.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


def test_fill_bc_stack_matches_jax_and_keeps_data():
    jd, td = _containers(("periodic", "periodic"), ("hse", "hse"))
    rng = np.random.default_rng(2)
    s = 1.0 + rng.random((4, jd.grid.qx, jd.grid.qy))
    want = np.asarray(jd.fill_bc_stack(jnp.asarray(s)))
    before = td.data.clone()
    got = td.fill_bc_stack(torch.as_tensor(s.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    assert torch.equal(td.data, before)


def test_views_and_embed():
    g = Cartesian2d(6, 5, ng=4)
    a = torch.arange(g.qx * g.qy, dtype=torch.float64).reshape(g.qx, g.qy)
    v = ai(a, g)
    assert torch.equal(v.v(), a[4:10, 4:9])
    assert torch.equal(v.ip(-1, buf=1), a[2:10, 3:10])
    assert torch.equal(v.ip_jp(1, -2, buf=(2, 1)), a[3:12, 0:8])
    e = embed(v.v(buf=1), g, 1, ishift=1)
    assert e.shape == a.shape
    assert torch.equal(e[4:12, 3:10], a[3:11, 3:10])
    assert float(e.sum()) == float(a[3:11, 3:10].sum())
