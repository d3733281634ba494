"""The launch plans the fused CUDA kernels take from Python: the CTU step's
tiles, grid, halos and shared-memory layout (ctu_kernel.plan), and the
multigrid core's level schedule, cluster and shared-memory layout
(mg_kernel.core_plan).  They run on the CPU: nothing is compiled or
launched."""

import itertools

import numpy as np
import pytest
import torch

from pyro2_tpu_torch.multigrid import mg_kernel
from pyro2_tpu_torch.solvers.compressible import ctu_kernel
from pyro2_tpu_torch.solvers.compressible.simulation import Variables

DTYPES = (torch.float32, torch.float64)
NG = 4                 # the ghost cells of the compressible frames
SMEM_LIMIT = 232448    # shared memory one block may opt into on the H100


def _grids(dtype):
    """Ragged grids: 200x136, one cell, and 7 x 5 tiles' worth with a
    ragged last tile each way."""
    tx, ty = ctu_kernel.TILE[dtype]
    return ((200, 136), (1, 1), (7 * tx - 3, 5 * ty - 1), (7 * tx, 5 * ty))


# -- the CTU step -------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_members", [1, 3])
def test_ctu_tiles_cover_every_cell_once(dtype, n_members):
    """The grid the kernel launches (the plan's ints) has a block for each
    tile of every member, and the tiles, clipped to the frame, cover each
    interior cell exactly once."""
    for nx, ny in _grids(dtype):
        p = ctu_kernel.plan(nx, ny, 4, dtype, n_members=n_members)
        gy, gx, gz = p.grid
        assert gz == n_members
        assert p.ints()[-2:] == [gy, gx]
        assert (gx - 1) * p.tx < nx <= gx * p.tx
        assert (gy - 1) * p.ty < ny <= gy * p.ty
        for _ in range(gz):                 # every member: the same tiling
            interior = np.zeros((nx + 2 * NG, ny + 2 * NG), dtype=int)
            for bi in range(gx):
                for bj in range(gy):
                    i0, j0 = NG + bi * p.tx, NG + bj * p.ty
                    interior[i0:min(i0 + p.tx, NG + nx),
                             j0:min(j0 + p.ty, NG + ny)] += 1
            assert (interior[NG:NG + nx, NG:NG + ny] == 1).all()
            assert interior.sum() == nx * ny


def test_ctu_halos_fit_the_ghosts():
    """Each box reaches as far as what reads it needs: the traced cells one
    beyond the tile (its high faces), the flattening coefficients one
    beyond them, the primitives two beyond both (the 4th-order slope and
    the flattening's pressures); the primitives' box, the widest, stays
    inside the frame's 4 ghosts.  The plan hands the kernel these halos."""
    h = ctu_kernel.HALO
    assert h["traced"] >= 1
    assert h["flatten"] >= h["traced"] + 1
    assert h["prim"] >= max(h["flatten"], h["traced"]) + 2
    assert max(h.values()) == h["prim"] <= NG
    p = ctu_kernel.plan(200, 136, 4, torch.float32)
    tx, ty, threads, hq, hx, ht = p.ints()[:6]
    assert (tx, ty) == ctu_kernel.TILE[torch.float32]
    assert threads == ctu_kernel.THREADS[torch.float32]
    assert (hq, hx, ht) == (4, 2, 1)
    assert ht >= 1 and hx >= ht + 1 and hq >= hx + 2 and hq <= NG


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nvar", range(4, ctu_kernel.MAXVAR + 1))
def test_ctu_shared_memory_fits(dtype, nvar):
    """Every configuration's block fits the 232,448 bytes a block may opt
    into, and its arrays lie one after another inside them."""
    item = torch.empty((), dtype=dtype).element_size()
    for spherical, with_sources, flatten in itertools.product(
            (False, True), (False, True), (False, True)):
        p = ctu_kernel.plan(200, 136, nvar, dtype,
                            spherical=spherical,
                            with_sources=with_sources,
                            flatten=flatten)
        assert 0 < p.smem <= SMEM_LIMIT
        end = 0
        for name in p.ARRAYS:
            size = p.sizes[name]
            assert p.offsets[name] == (end if size else -1)
            end += size
        assert end * item == p.smem
        assert (p.offsets["s"] >= 0) == with_sources
        assert (p.offsets["g"] >= 0) == spherical
        assert (p.offsets["xi"] >= 0) == flatten
        assert p.sizes["q"] == nvar * (p.tx + 8) * (p.ty + 8)
        assert p.sizes["st"] == 4 * nvar * (p.tx + 2) * (p.ty + 2)
        assert p.sizes["u"] == nvar * (p.tx + 2) * (p.ty + 2)
        assert p.ints()[-3] == p.smem


@pytest.mark.parametrize("dtype", DTYPES)
def test_ctu_traced_cells_fill_the_block(dtype):
    """A block's threads take one traced cell each in the phases that
    trace, solve and correct (the tile and its 1-cell halo)."""
    p = ctu_kernel.plan(1024, 1024, 4, dtype)
    assert p.box("traced") == p.threads == ctu_kernel.THREADS[dtype]
    assert p.threads % 32 == 0


@pytest.mark.parametrize("order,ng", [((1, 0, 2, 3), 4), ((0, 1, 2, 3), 3)])
def test_ctu_uncovered_frames_raise(order, ng):
    class _Vars:
        nvar = 4
        idens, iener, ixmom, iymom = order
    with pytest.raises(NotImplementedError, match="A.21"):
        ctu_kernel.covered(_Vars, ng)


def test_ctu_solver_order_is_covered():
    """The compressible solvers register density, energy, x- and
    y-momentum first: the order the kernel fixes at compile time."""
    from pyro2_tpu_torch import Pyro

    p = Pyro("compressible", device="cpu")
    p.initialize_problem("quad", inputs_dict={"mesh.nx": 8, "mesh.ny": 8})
    iv = p.sim.ivars
    assert isinstance(iv, Variables)
    assert (iv.idens, iv.iener, iv.ixmom, iv.iymom) == (0, 1, 2, 3)
    ctu_kernel.covered(iv, p.sim.cc_data.grid.ng)


# -- the multigrid core -------------------------------------------------------

def _tops(dtype):
    return range(int(np.log2(mg_kernel.CORE_MAX[dtype])))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", sorted(mg_kernel.FLAVOURS))
def test_core_schedule(dtype, op):
    """For every top the core holds: each level runs on a power of 2 of
    warps, never more than the block's 32 nor fewer than the next coarser
    level's; the levels up to 8^2 (the 2x2 bottom among them) run on one
    warp; and a level that takes more warps than the coarser one gives each
    lane at least one cell of a colour (a spread level: of its rows on one
    CTA).  Every operator takes the same levels."""
    for top in _tops(dtype):
        warps = mg_kernel.core_schedule(top)
        ctas, first = mg_kernel.core_cluster(top)
        assert len(warps) == top + 1
        for level, w in enumerate(warps):
            assert w & (w - 1) == 0 and 1 <= w <= mg_kernel.CORE_WARPS
            if mg_kernel.core_cells(level) <= 8:
                assert w == 1
            if level and w > warps[level - 1]:
                colour = mg_kernel.core_cells(level) ** 2 // 2
                if level >= first:
                    colour //= ctas
                assert 32 * (w // 2) < colour
            if level:
                assert w >= warps[level - 1]
    if dtype == torch.float32:
        assert mg_kernel.core_schedule(6) == [1, 1, 1, 4, 16, 16, 32]


@pytest.mark.parametrize("dtype", DTYPES)
def test_core_cluster(dtype):
    """The levels of CLUSTER_N or more cells a side are spread over the
    CORE_CTAS blocks of a cluster, by rows, 2 or more of them a block; a
    top below CLUSTER_N runs on one block alone, and level 0, the 2x2
    bottom, is never spread."""
    for top in _tops(dtype):
        ctas, first = mg_kernel.core_cluster(top)
        n_top = mg_kernel.core_cells(top)
        if n_top < mg_kernel.CLUSTER_N:
            assert (ctas, first) == (1, top + 1)
            continue
        assert ctas == mg_kernel.CORE_CTAS and ctas & (ctas - 1) == 0
        assert 1 <= first <= top
        for level in range(first, top + 1):
            rows = mg_kernel.core_cells(level) // ctas
            assert rows >= 2 and rows & (rows - 1) == 0
            assert mg_kernel.core_cells(level) >= mg_kernel.CLUSTER_N
        assert mg_kernel.core_cells(first - 1) < mg_kernel.CLUSTER_N
    assert mg_kernel.core_cluster(6) == (8, 5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_core_shared_memory_fits(dtype):
    """v and f of every level up to CORE_MAX fit one block's opt-in limit;
    one level more would not (CORE_MAX is the largest core)."""
    item = torch.empty((), dtype=dtype).element_size()
    top = int(np.log2(mg_kernel.CORE_MAX[dtype])) - 1
    assert mg_kernel.core_offsets(top)[-1] * item <= SMEM_LIMIT
    assert mg_kernel.core_offsets(top + 1)[-1] * item > SMEM_LIMIT
    assert mg_kernel.core_offsets(0) == [0, 2 * 16]


@pytest.mark.parametrize("top", range(7))
def test_core_plan_passes_the_kernels_checks(top):
    """The schedule array each core launch takes holds what mg_vcycle.cu's
    core() accepts: a power-of-2 warp count per level, never falling from
    coarse to fine; one block, or a cluster of CORE_CTAS whose first spread
    level has 2 or more rows a block; and v and f of each level's one-ghost
    frame one after another from offset 0."""
    plan = mg_kernel.core_plan(top)
    assert len(plan) == (top + 1) + 2 + (top + 2)
    warps, (ctas, first), off = plan[:top + 1], plan[top + 1:top + 3], \
        plan[top + 3:]
    assert warps == mg_kernel.core_schedule(top)
    for level, w in enumerate(warps):
        assert 1 <= w <= 32 and w & (w - 1) == 0
        assert level == 0 or w >= warps[level - 1]
    assert ctas in (1, mg_kernel.CORE_CTAS)
    assert 1 <= first <= top + 1 and (ctas > 1) == (first <= top)
    assert first > top or (2 << first) >= 2 * ctas
    assert off[0] == 0
    for level in range(top + 1):
        q = mg_kernel.core_cells(level) + 2
        assert off[level + 1] - off[level] == 2 * q * q
