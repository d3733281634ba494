"""Parity of the PyTorch port's mesh layer (pyro2_tpu_torch/parallel/
mesh_comm.py, launch.py, blocks.py) with pyro2_tpu's.

The port's ranks run under parallel.launch on gloo (CPU, float64, one
process per block) and never import JAX (tests/torch_rank_programs.py).
This process computes the JAX side inside shard_map on conftest's 8 fake
CPU devices, on the same mesh shape, from the same numpy inputs.  Every
exchange only copies and negates values, so each comparison is bitwise.
One launch per mesh shape (module fixtures) runs every program.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import pyro2_tpu.mesh.boundary as jbnd
import torch_rank_programs as trp
from pyro2_tpu.mesh.grid import Grid2d as JGrid2d
from pyro2_tpu.parallel import mesh_comm as jmc
from pyro2_tpu.parallel.blocks import block_grid as jblock_grid
from pyro2_tpu.parallel.blocks import blockwise_init_interior as jblockwise
from pyro2_tpu.util.runparams import RuntimeParameters as JRP
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.parallel import launch, mesh_comm
from pyro2_tpu_torch.parallel.blocks import block_grid
from pyro2_tpu_torch.util.runparams import RuntimeParameters

SHAPES = [(2, 2), (1, 4)]
NX, NY, NG = 16, 32, 2
KINDS = {
    "periodic": ("periodic",) * 4,
    "outflow": ("outflow",) * 4,
    "neumann": ("neumann",) * 4,
    "dirichlet": ("dirichlet",) * 4,
    "reflect_even": ("reflect-even",) * 4,
    "reflect_odd": ("reflect-odd",) * 4,
    "dirichlet_neumann_periodic": ("dirichlet", "neumann", "periodic",
                                   "periodic"),
    "periodic_odd_outflow": ("periodic", "periodic", "reflect-odd",
                             "outflow"),
}
DEEP = ["periodic", "dirichlet", "reflect_even", "dirichlet_neumann_periodic",
        "periodic_odd_outflow"]
DEPTH = 5                      # the deep halo on a split axis


def _interior():
    return np.random.default_rng(3).standard_normal((NX, NY))


def _depths(shape):
    return (DEPTH if shape[0] > 1 else 1), (DEPTH if shape[1] > 1 else 1)


def _shear_params(cls, N=32):
    """The incompressible shear problem's runtime parameters of one
    package (as tests/test_parallel.py's TestBlockwiseInit)."""
    import importlib
    pkg = "pyro2_tpu_torch" if cls is RuntimeParameters else "pyro2_tpu"
    problem = importlib.import_module(
        f"{pkg}.solvers.incompressible.problems.shear")
    rp = cls()
    rp.load_params(f"{pkg}/_defaults")
    rp.load_params(f"{pkg}/solvers/incompressible/_defaults")
    for k, v in problem.PROBLEM_PARAMS.items():
        rp.set_param(k, v, no_new=False)
    for k, v in {"mesh.nx": N, "mesh.ny": N,
                 "mesh.xlboundary": "periodic",
                 "mesh.xrboundary": "periodic",
                 "mesh.ylboundary": "periodic",
                 "mesh.yrboundary": "periodic",
                 "driver.verbose": 0, "vis.dovis": 0,
                 "io.do_io": 0}.items():
        rp.set_param(k, v, no_new=False)
    return rp, problem


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request):
    """(mesh shape, each rank's results) of one launch on that shape."""
    shape = request.param
    dpx, dpy = _depths(shape)
    cases = [(name, KINDS[name], NG) for name in KINDS]
    deep = [(name, KINDS[name], dpx, dpy) for name in DEEP]
    rp, _ = _shear_params(RuntimeParameters)
    jobs = [("exchanges", (_interior(), cases, deep)),
            ("blockwise_init", (rp.params, "shear"))]
    return shape, launch.run(trp.several, shape, jobs, device="cpu",
                             timeout=240)


def _jbc(kinds):
    return jbnd.BC(xlb=kinds[0], xrb=kinds[1], ylb=kinds[2], yrb=kinds[3])


@pytest.fixture(scope="module")
def jax_side(ranks):
    """Every exchange of the JAX package on the ranks' mesh shape, in one
    shard_map program: {name: {(ix, iy): that device's block}}."""
    shape = ranks[0]
    px, py = shape
    dpx, dpy = _depths(shape)
    gl = JGrid2d(NX // px, NY // py, ng=NG)
    names = []

    def body(loc):
        out = []
        pad = jnp.pad(loc, NG)
        filled = pad.at[:NG].add(7.0).at[-NG:].add(-3.0).at[:, :NG].add(5.0)
        for name, kinds in KINDS.items():
            bc = _jbc(kinds)
            out += [jmc.halo_exchange(pad, gl, bc, px, py),
                    jmc.gated_physical_fill(filled, gl, bc, px, py),
                    jmc.seam_exchange(filled, gl, px, py)]
            names.extend(["halo_" + name, "gated_" + name, "seam_" + name])
        for name in DEEP:
            bc = _jbc(KINDS[name])
            for phys in (True, False):
                out.append(jmc.deep_pad_exchange(loc, bc, px, py, dpx, dpy,
                                                 phys=phys))
                names.append(f"deep_{name}_{phys}")
            out.append(jmc.deep_phys_refresh(
                jmc.deep_pad_exchange(loc, bc, px, py, dpx, dpy,
                                      phys=False), bc, px, py, dpx, dpy))
            names.append(f"refresh_{name}")
        return tuple(out)

    mesh = jmc.make_mesh(shape=shape)
    n_out = 3 * len(KINDS) + 3 * len(DEEP)
    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("x", "y"),
                               out_specs=(P("x", "y"),) * n_out))
    outs = fn(jnp.asarray(_interior()))
    blocks = {}
    for name, out in zip(names, outs):
        out = np.asarray(out)
        qx, qy = out.shape[0] // px, out.shape[1] // py
        blocks[name] = {(ix, iy): out[ix * qx:(ix + 1) * qx,
                                      iy * qy:(iy + 1) * qy]
                        for ix in range(px) for iy in range(py)}
    return blocks


def _rank_blocks(shape, results, key):
    px, py = shape
    return {(r // py, r % py): res[0][key] for r, res in enumerate(results)}


def _assert_blocks_equal(shape, jax_blocks, port_blocks):
    for pos, ref in jax_blocks.items():
        np.testing.assert_array_equal(port_blocks[pos], ref, err_msg=str(pos))


# -- the mesh -----------------------------------------------------------------

def test_factor_devices_matches_jax():
    for n in range(1, 17):
        assert mesh_comm.factor_devices(n) == jmc.factor_devices(n)
    assert mesh_comm._ring_perm(4) == jmc._ring_perm(4)
    assert mesh_comm._ring_perm_rev(4) == jmc._ring_perm_rev(4)


def test_make_mesh_without_a_process_group():
    assert not dist.is_initialized()
    mesh = mesh_comm.make_mesh(device="cpu")
    assert mesh.shape == (1, 1) and (mesh.ix, mesh.iy) == (0, 0)
    assert mesh.device == torch.device("cpu")
    assert not dist.is_initialized()
    # one block needs no collective
    t = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(mesh.psum(t), t)
    assert torch.equal(mesh.all_gather("x", t, 0), t)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_comm.make_mesh()           # CUDA by default: none here
    with pytest.raises(ValueError, match="process group"):
        mesh_comm.make_mesh(shape=(2, 2), device="cpu")


def test_ranks_hold_their_blocks_and_reduce_globally(ranks):
    shape, results = ranks
    px, py = shape
    interior = _interior()
    for r, res in enumerate(results):
        out = res[0]
        assert tuple(out["coords"]) == (r // py, r % py)
        np.testing.assert_array_equal(out["gather"], interior)
        np.testing.assert_array_equal(
            out["psum"], [px * py, py * sum(range(px)), px * sum(range(py))])


# -- the exchanges, bitwise against the JAX package ---------------------------

@pytest.mark.parametrize("name", list(KINDS))
def test_halo_exchange_bitwise(ranks, jax_side, name):
    shape, results = ranks
    _assert_blocks_equal(shape, jax_side["halo_" + name],
                         _rank_blocks(shape, results, "halo_" + name))


@pytest.mark.parametrize("name", list(KINDS))
def test_gated_fill_and_seam_exchange_bitwise(ranks, jax_side, name):
    shape, results = ranks
    for kind in ("gated_", "seam_"):
        _assert_blocks_equal(shape, jax_side[kind + name],
                             _rank_blocks(shape, results, kind + name))


@pytest.mark.parametrize("name", DEEP)
def test_deep_pad_exchange_and_refresh_bitwise(ranks, jax_side, name):
    # the outer halo rows of a non-periodic split axis keep the ring's
    # wrapped payload in both packages
    shape, results = ranks
    for key in (f"deep_{name}_True", f"deep_{name}_False",
                f"refresh_{name}"):
        _assert_blocks_equal(shape, jax_side[key],
                             _rank_blocks(shape, results, key))


# -- per-block initialization -------------------------------------------------

def test_block_grid_coords_bitwise():
    g = Grid2d(32, 16, ng=4, xmin=-1.0, xmax=3.0, ymin=0.5, ymax=2.5)
    jg = JGrid2d(32, 16, ng=4, xmin=-1.0, xmax=3.0, ymin=0.5, ymax=2.5)
    px, py = 4, 2
    for ix in range(px):
        for iy in range(py):
            bg = block_grid(g, px, py, ix, iy)
            jbg = jblock_grid(jg, px, py, ix, iy)
            assert (bg.nx, bg.ny, bg.dx, bg.dy) == (jbg.nx, jbg.ny, jbg.dx,
                                                    jbg.dy)
            for name in ("x", "y", "x2d", "y2d", "xl2d", "yr2d"):
                np.testing.assert_array_equal(getattr(bg, name),
                                              getattr(jbg, name))
            np.testing.assert_array_equal(
                bg.x2d, g.x2d[ix * 8:ix * 8 + 8 + 8, iy * 8:iy * 8 + 8 + 8])


def test_blockwise_init_matches_jax(ranks):
    from pyro2_tpu.solvers import incompressible

    shape, results = ranks
    px, py = shape
    rp, problem = _shear_params(JRP)
    gs = incompressible.Simulation("incompressible", "shear",
                                   problem.init_data, rp)
    gs.initialize()
    ref = np.asarray(jblockwise(gs.cc_data, problem.init_data, rp,
                                jmc.make_mesh(shape=shape)))
    bx, by = ref.shape[1] // px, ref.shape[2] // py
    for r, res in enumerate(results):
        ix, iy = r // py, r % py
        np.testing.assert_array_equal(
            res[1], ref[:, ix * bx:(ix + 1) * bx, iy * by:(iy + 1) * by])


# -- the launcher -------------------------------------------------------------

def test_launch_raises_when_a_rank_never_sends():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish never_sends"):
        launch.run(trp.never_sends, (1, 2), device="cpu", timeout=8)
    assert time.monotonic() - t0 < 40


def test_launch_raises_a_rank_error():
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 failed.*on purpose"):
        launch.run(trp.raises, (1, 2), device="cpu", timeout=120)


def test_launch_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """The launcher's ranks run on CUDA by default: with no GPU and no
    device given it raises before it starts a rank, instead of running
    them on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(launch.mp, "get_context",
                        lambda *a: started.append(a) or None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch.run(trp.several, (1, 2), [], timeout=8)
    assert started == []
