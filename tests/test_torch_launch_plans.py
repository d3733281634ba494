"""The launch plans the fused CUDA kernels take from Python: the CTU step's
tiles, grid, halos and shared-memory layout (ctu_kernel.plan), the rk and
fv4 stage increments' (mol_kernel.rk_plan, mol_kernel.plan), the swe
step's (swe_kernel.plan), the multigrid core's level schedule, cluster and
shared-memory layout (mg_kernel.core_plan), the multigrid descent's and
ascent's tiles, halo and rounds (mg_kernel.tile_plan), and the sharded
multigrid's deep smoothing round's tiles, halo, sub-rounds and boxes
(sharded_mg_kernel.deep_plan), and the lm_atm interface stages' tiles,
halos and shared-memory layout (lm_kernel.plan); and that the cavity's
moving lid leaves the multigrid's launches and plans as they are.  They
run on the CPU: nothing is compiled or launched."""

import itertools

import numpy as np
import pytest
import torch

from pyro2_tpu_torch.multigrid import mg_kernel
from pyro2_tpu_torch.multigrid import sharded_mg_kernel as smk
from pyro2_tpu_torch.solvers.compressible import ctu_kernel
from pyro2_tpu_torch.solvers.compressible.simulation import Variables
from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel
from pyro2_tpu_torch.solvers.lm_atm import lm_kernel
from pyro2_tpu_torch.solvers.swe import swe_kernel

DTYPES = (torch.float32, torch.float64)
NG = 4                 # the ghost cells of the compressible frames
SMEM_LIMIT = 232448    # shared memory one block may opt into on the H100
SMEM_SM = 233472       # shared memory of one SM that its blocks may share


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


# -- the fused fv4 stage increment --------------------------------------------

def _fv4_grids(dtype):
    """Ragged grids: 200x136, one cell, and 7 x 5 tiles' worth with a
    ragged last tile each way."""
    tx, ty = mol_kernel.TILE[dtype]
    return ((200, 136), (1, 1), (7 * tx - 3, 5 * ty - 1), (7 * tx, 5 * ty))


def _fv4_plan_ok(item, nx, ny, nvar, flatten, plan_ints):
    """mol_substep.cu's fv4_plan_ok, line by line, on a plan's ints."""
    (tx, ty, threads, hq, ha, hx, hs, q, xi, sc, qix, qiy, r, smem, bx,
     by) = plan_ints

    def box(h):
        return (tx + 2 * h) * (ty + 2 * h)

    if threads < 32 or threads > (512 if item == 4 else 256) or \
            threads % 32 or tx < 1 or ty < 1:
        return False
    if hs < 1 or hx < hs + 1 or ha < hs + 3 or hq < ha + 1 or hq < hx + 2:
        return False
    if bx < 1 or by < 1 or (bx - 1) * ty >= ny or bx * ty < ny or \
            (by - 1) * tx >= nx or by * tx < nx:
        return False
    states = nvar * box(ha) + max(2 * nvar * box(hs), nvar * box(hq))
    fluxes = nvar * ((tx + 1) * ty + tx * (ty + 1))
    end = 0
    for off, size in ((q, nvar * box(hq)), (xi, 2 * box(hx) if flatten else 0),
                      (sc, 2 * box(hs)), (qix, nvar * (tx + 1) * (ty + 2)),
                      (qiy, nvar * (tx + 2) * (ty + 1)),
                      (r, max(states, fluxes))):
        if size == 0:
            continue
        if off < end:
            return False
        end = off + size
    return end * item <= smem


@pytest.mark.parametrize("dtype", DTYPES)
def test_fv4_tiles_cover_every_cell_once(dtype):
    """The grid the fv4 kernel launches has a block for each tile, and the
    tiles, clipped to the frame, cover each interior cell exactly once;
    the blocks at the frame's edges own its ghost rows and columns, so k's
    ghosts are written once too."""
    for nx, ny in _fv4_grids(dtype):
        p = mol_kernel.plan(nx, ny, 4, dtype)
        gy, gx = p.grid
        assert p.ints()[-2:] == [gy, gx]
        owned = np.zeros((nx + 2 * NG, ny + 2 * NG), dtype=int)
        for bi in range(gx):
            for bj in range(gy):
                i0, j0 = NG + bi * p.tx, NG + bj * p.ty
                r0 = 0 if bi == 0 else i0
                r1 = nx + 2 * NG if bi == gx - 1 else i0 + p.tx
                c0 = 0 if bj == 0 else j0
                c1 = ny + 2 * NG if bj == gy - 1 else j0 + p.ty
                owned[r0:r1, c0:c1] += 1
        assert (owned == 1).all()


def _win(ng, nx, ny, b):
    """(i, j) -> inside the window [ilo - b, ihi + b] x [jlo - b, jhi + b]."""
    return lambda i, j: (ng - b <= i <= ng + nx - 1 + b and
                         ng - b <= j <= ng + ny - 1 + b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("where", ["first", "last", "middle"])
def test_fv4_stage_boxes_stay_inside_the_ghosts(dtype, where):
    """Every stage of the fused fv4 kernel, on the tile at the frame's
    first corner, its last (ragged) corner or inside it: each cell a stage
    computes reads only cells that a stage before it computed, inside the
    box that holds them, and every cell read from the state lies in the
    frame, inside its 4 ghosts, although the boxes reach 5 cells past the
    tile: the windows decide, by global index, which cells read how far
    (mol_substep.cu k_fv4)."""
    p = mol_kernel.plan(37, 29, 4, dtype)
    nx, ny, ng = p.nx, p.ny, NG
    qx, qy = nx + 2 * ng, ny + 2 * ng
    gy, gx = p.grid
    bi, bj = {"first": (0, 0), "last": (gx - 1, gy - 1),
              "middle": (gx // 2, gy // 2)}[where]
    i0, j0 = ng + bi * p.tx, ng + bj * p.ty
    h = p.halo

    def box(hh, di=(0, 0), dj=(0, 0)):
        """Cells of a box around the tile, clipped to the frame."""
        return {(i, j)
                for i in range(i0 - hh - di[0], i0 + p.tx + hh + di[1])
                for j in range(j0 - hh - dj[0], j0 + p.ty + hh + dj[1])
                if 0 <= i < qx and 0 <= j < qy}

    inside = lambda i, j: 0 <= i < qx and 0 <= j < qy
    w = {b: _win(ng, nx, ny, b) for b in (0, 1, 2, 3)}

    def reads_ok(reads, held):
        for c in reads:
            assert inside(*c) and c in held, c

    # 1. the state over box q; Q over box q; the centres over box a, whose
    # Laplacian inside the buf=ng-1 window reads the state's box; the
    # sources over box s
    Qc = box(h["prim"])
    Ac = box(h["avg"])
    Sc = box(h["states"])
    for i, j in Ac:
        if w[3](i, j):
            reads_ok([(i + 1, j), (i - 1, j), (i, j + 1), (i, j - 1)], Qc)
    # 2. the flattening coefficients over box x; 3. the averages over box a
    Xc = box(h["flatten"])
    for i, j in Xc:
        if w[2](i, j):
            reads_ok([(i + a, j) for a in (-2, -1, 1, 2)] +
                     [(i, j + a) for a in (-2, -1, 1, 2)], Qc)
    for i, j in Ac:
        if w[3](i, j):
            reads_ok([(i + 1, j), (i - 1, j), (i, j + 1), (i, j - 1)], Qc)
    # 4. the limited states of box s's cells in the buf=1 window, read 3
    # cells along each direction, the flattening 1 cell around
    St = {c for c in Sc if w[1](*c)}
    for i, j in St:
        reads_ok([(i + a, j) for a in range(-3, 4)] +
                 [(i, j + a) for a in range(-3, 4)], Ac)
        reads_ok([(i + a, j + b) for a in (-1, 0, 1) for b in (-1, 0, 1)
                  if a == 0 or b == 0], Xc)
    ilo, ihi, jlo, jhi = ng, ng + nx - 1, ng, ng + ny - 1
    qix = {(i, j) for i in range(i0, i0 + p.tx + 1)
           for j in range(j0 - 1, j0 + p.ty + 1)
           if ilo <= i <= ihi + 1 and jlo - 1 <= j <= jhi + 1}
    qiy = {(i, j) for i in range(i0 - 1, i0 + p.tx + 1)
           for j in range(j0, j0 + p.ty + 1)
           if jlo <= j <= jhi + 1 and ilo - 1 <= i <= ihi + 1}
    for i, j in qix:
        reads_ok([(i, j), (i - 1, j)], St)
    for i, j in qiy:
        reads_ok([(i, j), (i, j - 1)], St)
    # 5. the fluxes of the tile's faces
    fx = {(i, j) for i in range(i0, i0 + p.tx + 1)
          for j in range(j0, j0 + p.ty)
          if ilo <= i <= ihi + 1 and jlo <= j <= jhi}
    fy = {(i, j) for i in range(i0, i0 + p.tx) for j in range(j0, j0 + p.ty + 1)
          if jlo <= j <= jhi + 1 and ilo <= i <= ihi}
    for i, j in fx:
        reads_ok([(i, j - 1), (i, j), (i, j + 1)], qix)
        reads_ok([(i - a, j + b) for a in (0, 1) for b in (-1, 0, 1)], Qc)
    for i, j in fy:
        reads_ok([(i - 1, j), (i, j), (i + 1, j)], qiy)
        reads_ok([(i + a, j - b) for a in (-1, 0, 1) for b in (0, 1)], Qc)
    # 6. the tile's interior cells: the divergence and the averaged sources
    for i in range(i0, i0 + p.tx):
        for j in range(j0, j0 + p.ty):
            if w[0](i, j):
                reads_ok([(i, j), (i + 1, j)], fx)
                reads_ok([(i, j), (i, j + 1)], fy)
                reads_ok([(i, j), (i + 1, j), (i - 1, j), (i, j + 1),
                          (i, j - 1)], Sc)
    # the halos the plan hands the kernel are these
    assert p.ints()[3:7] == [h["prim"], h["avg"], h["flatten"],
                             h["states"]] == [5, 4, 2, 1]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nvar", range(4, ctu_kernel.MAXVAR + 1))
def test_fv4_shared_memory_fits(dtype, nvar):
    """Every variable count and dtype, with and without flattening, fits
    the 232,448 bytes a block may opt into; the arrays lie one after
    another, the fluxes over the averages and states once stage 4 is
    done."""
    item = torch.empty((), dtype=dtype).element_size()
    for flatten in (False, True):
        p = mol_kernel.plan(200, 136, nvar, dtype, flatten=flatten)
        assert 0 < p.smem <= SMEM_LIMIT
        end = 0
        for name in p.ARRAYS:
            size = p.sizes[name]
            assert p.offsets[name] == (end if size else -1)
            end += size
        assert end * item == p.smem
        assert (p.offsets["xi"] >= 0) == flatten
        tx, ty = p.tx, p.ty
        assert p.sizes["r"] >= nvar * ((tx + 1) * ty + tx * (ty + 1))
        assert p.sizes["r"] >= nvar * p.box("avg") + nvar * p.box("prim")


@pytest.mark.parametrize("dtype", DTYPES)
def test_fv4_plan_passes_the_kernels_checks(dtype):
    """The plan array each fv4 launch takes has the length mol_substep.cu
    reads (FV4_PLAN_INTS) and passes its fv4_plan_ok, for every variable
    count, with and without flattening, on ragged grids."""
    import re

    from pyro2_tpu_torch.util import cuda_build

    text = (cuda_build.CSRC / "mol_substep.cu").read_text()
    n_ints = int(re.search(r"constexpr int FV4_PLAN_INTS = (\d+);",
                           text).group(1))
    for nx, ny in _fv4_grids(dtype):
        for nvar in range(4, ctu_kernel.MAXVAR + 1):
            for flatten in (False, True):
                p = mol_kernel.plan(nx, ny, nvar, dtype, flatten=flatten)
                ints = p.ints()
                assert len(ints) == n_ints
                item = torch.empty((), dtype=dtype).element_size()
                assert _fv4_plan_ok(item, nx, ny, nvar, flatten, ints)


def test_fv4_uncovered_variable_order_raises():
    class _Vars:
        nvar = 4
        idens, iener, ixmom, iymom = 1, 0, 2, 3
    with pytest.raises(NotImplementedError, match="A.22"):
        mol_kernel.covered(_Vars)


# -- the multigrid ascent (mg_up) ---------------------------------------------

UP_NSMOOTH = (0, 1, 10, 50)      # 50: more than one round's halo holds


def _tile_plan_ok(p, n, nsmooth, item, ints, op="const"):
    """mg_vcycle.cu tiled()'s checks, line by line, on the plan's ints:
    the boxes of v and f (rows 0: the coefficient operators, and the
    constant operator's tiles below 64^2), or the constant operator's
    register-resident plan (RegTile's rows and threads: mg_kernel.TILE_ROWS,
    TILE_THREADS; each thread's slots of 2 rows + 1 values of v and f)."""
    tile, halo, rounds, iters, threads, smem, tiles, rows = ints
    dtype = torch.float32 if item == 4 else torch.float64
    want = 1 if nsmooth == 0 else -(-nsmooth // max(iters, 1))
    if tile < 2 or tile & (tile - 1) or tile > n or tiles * tile != n or \
            iters < 0 or (nsmooth > 0 and iters < 1) or rounds != want or \
            halo < 2 * iters + 1:
        return False
    w = tile + 2 * halo
    if smem < 1 or threads % 32 or threads < 32 or (rows and op != "const"):
        return False
    if rows == 0:
        return threads <= 512 and 2 * w * w * item <= smem
    return rows == mg_kernel.TILE_ROWS[dtype] and \
        (w // 2) * -(-w // rows) <= threads <= \
        mg_kernel.TILE_THREADS[dtype] and \
        2 * threads * (2 * rows + 1) * item <= smem


def _smem_fits(p, dtype):
    """A plan's shared memory: the register-resident plan's slots of v and
    f for each thread, within a block's opt-in limit and the SM's for the
    blocks its kernels are built for; the boxes of v and f within
    TILE_SMEM, so that two blocks share an SM."""
    item = torch.empty((), dtype=dtype).element_size()
    w = p.tile + 2 * p.halo
    if p.rows == 0:
        return p.smem == 2 * w * w * item and \
            p.smem <= mg_kernel.TILE_SMEM <= SMEM_LIMIT // 2
    return p.smem == 2 * p.threads * (2 * p.rows + 1) * item and \
        p.smem <= SMEM_LIMIT and \
        mg_kernel.TILE_SM_BLOCKS[dtype] * (p.smem + 1024) <= SMEM_SM


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", sorted(mg_kernel.FLAVOURS))
def test_up_tiles_cover_every_level_once(dtype, op):
    """For every level from 4^2 to 1024^2, with the operator's plan (the
    constant operator's register-resident 64^2 tiles, else boxes), the
    tiles of the launch's grid cover the interior exactly once."""
    for k in range(2, 11):
        n = 2 ** k
        for nsmooth in UP_NSMOOTH:
            p = mg_kernel.tile_plan(n, nsmooth, dtype, op)
            assert p.tile & (p.tile - 1) == 0 and p.tiles * p.tile == n
            cover = np.zeros((n, n), dtype=int)
            for bi in range(p.tiles):
                for bj in range(p.tiles):
                    cover[bi * p.tile:(bi + 1) * p.tile,
                          bj * p.tile:(bj + 1) * p.tile] += 1
            assert (cover == 1).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nsmooth", UP_NSMOOTH)
def test_up_halo_covers_the_sweeps_reach(dtype, nsmooth):
    """The halo is as deep as a round's reach: one cell per half-sweep and
    one for the residual; the rounds take nsmooth iterations together, the
    last one the rest; the solvers' nsmooth (10) takes one round at every
    level, and 50 more than one at 1024^2, for every operator."""
    for op in sorted(mg_kernel.FLAVOURS):
        for k in range(2, 11):
            n = 2 ** k
            p = mg_kernel.tile_plan(n, nsmooth, dtype, op)
            its = p.round_iters()
            assert len(its) == p.rounds and sum(its) == nsmooth
            assert all(0 < i <= p.iters for i in its) or nsmooth == 0
            assert p.halo >= 2 * max(its) + 1
            if nsmooth <= 10:
                assert p.rounds == 1
        assert mg_kernel.tile_plan(1024, 50, dtype, op).rounds > 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_up_shared_memory_fits(dtype):
    """Every plan's shared memory fits a block's opt-in limit and the SM
    holds the blocks its kernels are built for (_smem_fits)."""
    for op in sorted(mg_kernel.FLAVOURS):
        for k in range(2, 11):
            for nsmooth in UP_NSMOOTH:
                p = mg_kernel.tile_plan(2 ** k, nsmooth, dtype, op)
                assert _smem_fits(p, dtype), (op, k, nsmooth)


@pytest.mark.parametrize("dtype", DTYPES)
def test_up_plan_passes_the_kernels_checks(dtype):
    """The plan array each mg_up launch takes has the length mg_vcycle.cu
    reads (TILE_PLAN_INTS) and passes its checks at every level and
    nsmooth, for every operator."""
    import re

    from pyro2_tpu_torch.util import cuda_build

    text = (cuda_build.CSRC / "mg_vcycle.cu").read_text()
    n_ints = int(re.search(r"constexpr int TILE_PLAN_INTS = (\d+);",
                           text).group(1))
    item = torch.empty((), dtype=dtype).element_size()
    for op in sorted(mg_kernel.FLAVOURS):
        for k in range(2, 11):
            for nsmooth in UP_NSMOOTH:
                p = mg_kernel.tile_plan(2 ** k, nsmooth, dtype, op)
                assert len(p.ints()) == n_ints
                assert _tile_plan_ok(p, 2 ** k, nsmooth, item, p.ints(), op)


# -- the multigrid descent (mg_down) ------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_down_tiles_cover_every_level_once(dtype):
    """For every level from 4^2 to 1024^2 and every operator's plan, the
    tiles of the launch's grid cover the interior exactly once; each tile
    is even and starts at an odd index, so it holds the four children of
    each of its coarse cells, and the coarse cells of the tiles cover the
    coarse level exactly once."""
    for op in sorted(mg_kernel.FLAVOURS):
        for k in range(2, 11):
            n = 2 ** k
            for nsmooth in UP_NSMOOTH:
                p = mg_kernel.tile_plan(n, nsmooth, dtype, op)
                assert p.tile & (p.tile - 1) == 0 and p.tiles * p.tile == n
                assert p.tile >= 2 and p.tile % 2 == 0
                cover = np.zeros((n + 2, n + 2), dtype=int)
                coarse = np.zeros((n // 2 + 2, n // 2 + 2), dtype=int)
                for bi in range(p.tiles):
                    for bj in range(p.tiles):
                        ti, tj = 1 + bi * p.tile, 1 + bj * p.tile
                        assert ti % 2 == 1 and tj % 2 == 1
                        cover[ti:ti + p.tile, tj:tj + p.tile] += 1
                        I0, J0 = (ti + 1) // 2, (tj + 1) // 2
                        coarse[I0:I0 + p.tile // 2,
                               J0:J0 + p.tile // 2] += 1
                assert (cover[1:-1, 1:-1] == 1).all()
                assert cover.sum() == n * n
                assert (coarse[1:-1, 1:-1] == 1).all()
                assert coarse.sum() == (n // 2) ** 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nsmooth", UP_NSMOOTH)
def test_down_halo_covers_the_sweeps_reach(dtype, nsmooth):
    """The halo is the sweeps' reach plus one: one cell per half-sweep of a
    round and one for the residual the restriction reads; the rounds take
    nsmooth iterations together; the solvers' nsmooth (10) takes one round
    at every level, and 50 more than one at 1024^2, for every operator."""
    for op in sorted(mg_kernel.FLAVOURS):
        for k in range(2, 11):
            p = mg_kernel.tile_plan(2 ** k, nsmooth, dtype, op)
            its = p.round_iters()
            assert len(its) == p.rounds and sum(its) == nsmooth
            assert all(0 < i <= p.iters for i in its) or nsmooth == 0
            assert p.halo == 2 * p.iters + 1 >= 2 * max(its) + 1
            if nsmooth <= 10:
                assert p.rounds == 1
        assert mg_kernel.tile_plan(1024, 50, dtype, op).rounds > 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_down_shared_memory_fits(dtype):
    """Every descent plan's shared memory fits (_smem_fits), its threads
    are within the kernels' launch bounds, and it passes the checks of
    mg_vcycle.cu's tiled(), which the descent and the ascent share."""
    item = torch.empty((), dtype=dtype).element_size()
    for op in sorted(mg_kernel.FLAVOURS):
        for k in range(2, 11):
            for nsmooth in UP_NSMOOTH:
                p = mg_kernel.tile_plan(2 ** k, nsmooth, dtype, op)
                assert _smem_fits(p, dtype)
                assert p.threads <= (mg_kernel.TILE_THREADS[dtype]
                                     if p.rows else mg_kernel.BOX_THREADS)
                assert _tile_plan_ok(p, 2 ** k, nsmooth, item, p.ints(), op)


# -- the cavity's moving lid: the same launches, one edge kind apart ----------

def _recorded_cycle(mg, dtype, monkeypatch):
    """The entries one V-cycle of `mg` calls on a CUDA-like (meta) frame
    and every argument each takes, with the library stubbed to record
    them: [(entry, [ints, array contents, ...]), ...]."""
    calls = []

    def value(a):
        if isinstance(a, mg_kernel.ctypes.Array):
            return ("array", list(a))
        return ("int", a) if isinstance(a, int) else ("ptr", None)

    class Lib:
        def __getattr__(self, name):
            def fn(*args):
                calls.append((name, [value(a) for a in args]))
                return 0
            return fn

        def mg_tile_plan_ints(self):
            return len(mg_kernel.TilePlan.FIELDS)

    monkeypatch.setattr(mg_kernel, "_load", lambda: Lib())
    monkeypatch.setattr(mg_kernel, "_check_tensors", lambda *a: None)
    monkeypatch.setattr(mg_kernel, "_run",
                        lambda fn, device, *args: fn(*args, None))
    g = mg.soln_grid
    mg_kernel.cycle(mg, None, torch.zeros((g.qx, g.qy), dtype=dtype,
                                          device="meta"))
    return calls


@pytest.mark.parametrize("dtype", DTYPES)
def test_cavity_plans_equal_the_neumann_case(dtype, monkeypatch):
    """The moving lid's ZERO edge adds no launch and changes no plan: a
    1024^2 cycle of the cavity's Crank-Nicolson operator calls the same
    entries with the same core schedule, tile plans, sizes and
    coefficients as on Neumann walls; only the edge kinds differ, at the
    lid and at its three Dirichlet walls."""
    import pyro2_tpu_torch.mesh.boundary as bnd
    from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d
    from pyro2_tpu_torch.solvers.incompressible_viscous import BC

    bnd.define_bc("moving_lid", BC.user, is_solid=False)
    kw = dict(alpha=1.0, beta=0.5 * (0.8 / 1024) * 0.0025, device="cpu",
              dtype=dtype)
    cavity = CellCenterMG2d(1024, 1024, xl_BC_type="dirichlet",
                            xr_BC_type="dirichlet", yl_BC_type="dirichlet",
                            yr_BC_type="moving_lid", **kw)
    neumann = CellCenterMG2d(1024, 1024, xl_BC_type="neumann",
                             xr_BC_type="neumann", yl_BC_type="neumann",
                             yr_BC_type="neumann", **kw)
    got = _recorded_cycle(cavity, dtype, monkeypatch)
    ref = _recorded_cycle(neumann, dtype, monkeypatch)
    peeled = len(mg_kernel.split(cavity, dtype)[1])
    assert [n for n, _ in got] == [n for n, _ in ref]
    assert len(got) == 1 + 2 * peeled and peeled > 0
    for (name, a), (_, b) in zip(got, ref):
        kinds = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        assert len(kinds) == 1, name           # the kinds array alone
        assert a[kinds[0]] == ("array", [1, 1, 1, mg_kernel.ZERO])
        assert b[kinds[0]] == ("array", [0, 0, 0, 0])


# -- the swe step -------------------------------------------------------------

def _swe_grids(dtype):
    """Ragged grids: 200x136, one cell, 1024x1000, and 7 x 5 tiles' worth
    with a ragged last tile each way."""
    p = swe_kernel.plan(1, 1, 4, dtype)
    tx, ty = p.tx, p.ty
    return ((200, 136), (1, 1), (1024, 1000), (7 * tx - 3, 5 * ty - 1),
            (7 * tx, 5 * ty))


@pytest.mark.parametrize("dtype", DTYPES)
def test_swe_tiles_cover_every_cell_once(dtype):
    """The grid the swe kernel launches (the plan's ints) has a block for
    each tile, and the tiles, clipped to the frame, cover each interior
    cell exactly once; the blocks at the frame's edges own its ghost rows
    and columns, so every cell of the output is written once."""
    for nx, ny in _swe_grids(dtype):
        p = swe_kernel.plan(nx, ny, 4, dtype)
        gy, gx = p.grid
        assert p.ints()[-2:] == [gy, gx]
        assert (gx - 1) * p.tx < nx <= gx * p.tx
        assert (gy - 1) * p.ty < ny <= gy * p.ty
        owned = np.zeros((nx + 2 * NG, ny + 2 * NG), dtype=int)
        interior = np.zeros_like(owned)
        for bi in range(gx):
            for bj in range(gy):
                i0, j0 = NG + bi * p.tx, NG + bj * p.ty
                r0 = 0 if bi == 0 else i0
                r1 = nx + 2 * NG if bi == gx - 1 else i0 + p.tx
                c0 = 0 if bj == 0 else j0
                c1 = ny + 2 * NG if bj == gy - 1 else j0 + p.ty
                owned[r0:r1, c0:c1] += 1
                interior[i0:min(i0 + p.tx, NG + nx),
                         j0:min(j0 + p.ty, NG + ny)] += 1
        assert (owned == 1).all()
        assert (interior[NG:NG + nx, NG:NG + ny] == 1).all()
        assert interior.sum() == nx * ny


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("where", ["first", "last", "middle"])
@pytest.mark.parametrize("limiter", [0, 1, 2])
def test_swe_phase_reads_stay_inside_the_frame(dtype, where, limiter):
    """Every phase of the fused swe kernel, on the tile at the frame's
    first corner, its last (ragged) corner or inside it: each value a phase
    reads was computed by a phase before it (a traced state inside the
    buf=2 window, a first-pass flux inside buf=1, a second-pass flux of the
    tile), inside the box that holds it, and every primitive read lies in
    the frame and in the box of the plan's halo (swe_step.cu k_swe)."""
    p = swe_kernel.plan(67, 45, 4, dtype)
    nx, ny, ng = p.nx, p.ny, NG
    qx, qy = nx + 2 * ng, ny + 2 * ng
    gy, gx = p.grid
    bi, bj = {"first": (0, 0), "last": (gx - 1, gy - 1),
              "middle": (gx // 2, gy // 2)}[where]
    i0, j0 = ng + bi * p.tx, ng + bj * p.ty
    h = p.halo

    def box(hh):
        return {(i, j) for i in range(i0 - hh, i0 + p.tx + hh)
                for j in range(j0 - hh, j0 + p.ty + hh)}

    w = {b: _win(ng, nx, ny, b) for b in (0, 1, 2)}
    ilo, ihi, jlo, jhi = ng, ng + nx - 1, ng, ng + ny - 1
    # 1. the primitives over box q, where it lies in the frame
    Q = {(i, j) for i, j in box(h["prim"]) if 0 <= i < qx and 0 <= j < qy}
    # 2. the traced cells of box t in the buf=2 window; their slopes read
    # the primitives 1 (limiters 0, 1) or 2 (limiter 2) cells along each
    # axis, a 2nd-order slope only inside buf=2
    bt = box(h["traced"])
    traced = {c for c in bt if w[2](*c)}
    for i, j in traced:
        reads = [(i + a, j) for a in (-1, 0, 1)] + \
            [(i, j + a) for a in (-1, 1)]
        if limiter == 2:
            for di, dj in ((1, 0), (0, 1)):
                for s in (-1, 1):
                    a, b = i + s * di, j + s * dj
                    if w[2](a, b):
                        reads += [(a + di, b + dj), (a - di, b - dj)]
        for c in reads:
            assert c in Q, (c, "primitive")
    # 3. the first pair on the faces of the box's cells with their left
    # neighbour in the box, inside buf=1: both states traced
    f1x = {(a, b) for a, b in bt if (a - 1, b) in bt and w[1](a, b)}
    f1y = {(a, b) for a, b in bt if (a, b - 1) in bt and w[1](a, b)}
    for a, b in f1x:
        assert (a - 1, b) in traced and (a, b) in traced
    for a, b in f1y:
        assert (a, b - 1) in traced and (a, b) in traced
    # 4. the second pair on the tile's faces the update reads
    fx = {(i, j) for i in range(i0, i0 + p.tx + 1)
          for j in range(j0, j0 + p.ty)
          if ilo <= i <= ihi + 1 and jlo <= j <= jhi}
    fy = {(i, j) for i in range(i0, i0 + p.tx)
          for j in range(j0, j0 + p.ty + 1)
          if ilo <= i <= ihi and jlo <= j <= jhi + 1}
    for i, j in fx:
        assert (i - 1, j) in traced and (i, j) in traced
        for c in ((i - 1, j + 1), (i - 1, j), (i, j + 1), (i, j)):
            assert c in f1y, (c, "first-pass y flux")
    for i, j in fy:
        assert (i, j - 1) in traced and (i, j) in traced
        for c in ((i + 1, j - 1), (i, j - 1), (i + 1, j), (i, j)):
            assert c in f1x, (c, "first-pass x flux")
    # 5. the update of the tile's interior cells
    for i in range(i0, i0 + p.tx):
        for j in range(j0, j0 + p.ty):
            if w[0](i, j):
                assert {(i, j), (i + 1, j)} <= fx
                assert {(i, j), (i, j + 1)} <= fy
    # the halos the plan hands the kernel are these, inside the ghosts
    assert p.ints()[3:5] == [h["prim"], h["traced"]] == [3, 1]
    assert h["prim"] == h["traced"] + 2 <= NG


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nvar", range(4, swe_kernel.MAXVAR + 1))
def test_swe_shared_memory_fits(dtype, nvar):
    """Every variable count fits the 232,448 bytes a block may opt into,
    two float32 blocks share an SM, and the arrays lie where the kernel's
    checks want them: the states apart from the primitives and the first
    pair, which may share their room."""
    item = torch.empty((), dtype=dtype).element_size()
    p = swe_kernel.plan(200, 136, nvar, dtype)
    assert 0 < p.smem <= SMEM_LIMIT
    if dtype == torch.float32:
        assert 2 * p.smem <= SMEM_SM
    assert _swe_plan_ok(item, 200, 136, nvar, p.ints())
    assert p.sizes["q"] == nvar * (p.tx + 6) * (p.ty + 6)
    assert p.sizes["st"] == 4 * nvar * (p.tx + 2) * (p.ty + 2)
    assert p.sizes["f1"] == 2 * nvar * (p.tx + 2) * (p.ty + 2)


def _swe_plan_ok(item, nx, ny, nvar, ints):
    """swe_step.cu run()'s checks, line by line, on a plan's ints."""
    tx, ty, threads, hq, ht, q, st, f1, smem, bx, by = ints
    if threads != (512 if item == 4 else 256) or tx < 1 or ty < 1 or \
            ht < 1 or hq < ht + 2 or NG < hq:
        return False
    if bx < 1 or by < 1 or (bx - 1) * ty >= ny or bx * ty < ny or \
            (by - 1) * tx >= nx or by * tx < nx:
        return False
    cq = (tx + 2 * hq) * (ty + 2 * hq)
    ct = (tx + 2 * ht) * (ty + 2 * ht)
    nq, nst, nf1 = nvar * cq, 4 * nvar * ct, 2 * nvar * ct
    end = smem // item

    def apart(a, na, b, nb):
        return a + na <= b or b + nb <= a

    return (min(q, st, f1) >= 0 and q + nq <= end and st + nst <= end and
            f1 + nf1 <= end and apart(st, nst, q, nq) and
            apart(st, nst, f1, nf1))


@pytest.mark.parametrize("dtype", DTYPES)
def test_swe_plan_passes_the_kernels_checks(dtype):
    """The plan array each swe launch takes has the length swe_step.cu
    reads (PLAN_INTS) and passes its run()'s checks for every variable
    count on ragged grids, and with other tiles."""
    import re

    from pyro2_tpu_torch.util import cuda_build

    text = (cuda_build.CSRC / "swe_step.cu").read_text()
    n_ints = int(re.search(r"constexpr int PLAN_INTS = (\d+);",
                           text).group(1))
    item = torch.empty((), dtype=dtype).element_size()
    for nx, ny in _swe_grids(dtype):
        for nvar in range(4, swe_kernel.MAXVAR + 1):
            for tile in (None, (5, 7), (62, 6)):
                p = swe_kernel.plan(nx, ny, nvar, dtype, tile)
                assert len(p.ints()) == n_ints
                assert _swe_plan_ok(item, nx, ny, nvar, p.ints())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nvar", range(4, swe_kernel.MAXVAR + 1))
def test_swe_traced_cells_fill_the_block(dtype, nvar):
    """A block's threads take the same number of traced cells each in the
    phases that trace and solve (the tile and its 1-cell halo): two in
    float32 up to 4 variables (the larger tile), else one; and the block
    leaves room for BLOCKS of them in an SM's shared memory."""
    p = swe_kernel.plan(1024, 1024, nvar, dtype)
    assert p.threads == swe_kernel.THREADS[dtype]
    each = 2 if dtype == torch.float32 and nvar <= 4 else 1
    assert p.box("traced") == each * p.threads
    assert swe_kernel.BLOCKS[dtype] * p.smem <= SMEM_SM


@pytest.mark.parametrize("nvar,ng", [(3, 4), (9, 4), (4, 2)])
def test_swe_uncovered_frames_raise(nvar, ng):
    with pytest.raises(NotImplementedError, match="A.23"):
        swe_kernel.covered(nvar, ng, torch.float32)


def test_swe_solver_frame_is_covered():
    """The swe solver's frame (4 ghosts, height and momenta at 0..2) is
    what the kernel takes, with passive scalars up to MAXVAR."""
    from pyro2_tpu_torch import Pyro

    p = Pyro("swe", device="cpu")
    p.initialize_problem("quad", inputs_dict={"mesh.nx": 8, "mesh.ny": 8})
    iv = p.sim.ivars
    assert (iv.ih, iv.ixmom, iv.iymom) == (0, 1, 2)
    for dtype in DTYPES:
        for nvar in range(iv.nvar, swe_kernel.MAXVAR + 1):
            swe_kernel.covered(nvar, p.sim.cc_data.grid.ng, dtype)


# -- the fused rk stage increment ---------------------------------------------

def _rk_grids(dtype):
    """Ragged grids: 200x136, one cell, 1024x1000, and 7 x 5 tiles' worth
    with a ragged last tile each way."""
    tx, ty = mol_kernel.RK_TILE[dtype]
    return ((200, 136), (1, 1), (1024, 1000), (7 * tx - 3, 5 * ty - 1),
            (7 * tx, 5 * ty))


def _rk_plan_ok(item, nx, ny, nvar, flatten, plan_ints):
    """mol_substep.cu's rk_plan_ok, line by line, on a plan's ints."""
    (tx, ty, threads, hq, hx, q, xi, s, fx, fy, smem, bx, by) = plan_ints

    def box(h):
        return (tx + 2 * h) * (ty + 2 * h)

    if threads < 32 or threads > (512 if item == 4 else 256) or \
            threads % 32 or tx < 1 or ty < 1:
        return False
    if hx < 2 or hq < hx + 2:
        return False
    if bx < 1 or by < 1 or (bx - 1) * ty >= ny or bx * ty < ny or \
            (by - 1) * tx >= nx or by * tx < nx:
        return False
    end = 0
    for off, size in ((q, nvar * box(hq)), (xi, 2 * box(hx) if flatten else 0),
                      (s, 2 * nvar * max((tx + 2) * ty, tx * (ty + 2))),
                      (fx, nvar * (tx + 1) * ty), (fy, nvar * tx * (ty + 1))):
        if size == 0:
            continue
        if off < end:
            return False
        end = off + size
    return end * item <= smem


@pytest.mark.parametrize("dtype", DTYPES)
def test_rk_tiles_cover_every_cell_once(dtype):
    """The grid the rk kernel launches has a block for each tile, and the
    tiles, clipped to the frame, cover each interior cell exactly once;
    the blocks at the frame's edges own its ghost rows and columns, so k's
    ghosts are written once too."""
    for nx, ny in _rk_grids(dtype):
        p = mol_kernel.rk_plan(nx, ny, 4, dtype)
        gy, gx = p.grid
        assert p.ints()[-2:] == [gy, gx]
        owned = np.zeros((nx + 2 * NG, ny + 2 * NG), dtype=int)
        for bi in range(gx):
            for bj in range(gy):
                i0, j0 = NG + bi * p.tx, NG + bj * p.ty
                r0 = 0 if bi == 0 else i0
                r1 = nx + 2 * NG if bi == gx - 1 else i0 + p.tx
                c0 = 0 if bj == 0 else j0
                c1 = ny + 2 * NG if bj == gy - 1 else j0 + p.ty
                owned[r0:r1, c0:c1] += 1
        assert (owned == 1).all()


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("limiter", [0, 1, 2])
@pytest.mark.parametrize("where", ["first", "last", "middle"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rk_stage_boxes_stay_inside_the_ghosts(dtype, where, limiter,
                                                flatten):
    """Every stage of the fused rk kernel, on the tile at the frame's first
    corner, its last (ragged) corner or inside it: each cell a stage
    computes reads only cells that a stage before it computed, inside the
    box that holds them, and every cell read from the state lies in the
    frame, inside its 4 ghosts, although the primitives' box reaches 4
    cells past the tile: the windows decide, by global index, which cells
    read how far (mol_substep.cu k_rk)."""
    p = mol_kernel.rk_plan(37, 45, 4, dtype, flatten=flatten)
    nx, ny, ng = p.nx, p.ny, NG
    qx, qy = nx + 2 * ng, ny + 2 * ng
    gy, gx = p.grid
    bi, bj = {"first": (0, 0), "last": (gx - 1, gy - 1),
              "middle": (gx // 2, gy // 2)}[where]
    i0, j0 = ng + bi * p.tx, ng + bj * p.ty
    h = p.halo
    inside = lambda i, j: 0 <= i < qx and 0 <= j < qy
    w = {b: _win(ng, nx, ny, b) for b in (0, 1, 2)}

    def box(rows, cols):
        return {(i, j) for i in rows for j in cols if inside(i, j)}

    def around(hh):
        return box(range(i0 - hh, i0 + p.tx + hh),
                   range(j0 - hh, j0 + p.ty + hh))

    def reads_ok(reads, held):
        for c in reads:
            assert inside(*c) and c in held, c

    def line(i, j, di, dj, reach):
        return [(i + a * di, j + a * dj) for a in range(-reach, reach + 1)]

    # 1. the primitives over box q, from the state at each cell
    Qc = around(h["prim"])
    # 2. the flattening coefficients over box x, reading the pressure 2 and
    # the velocities 1 cell along each direction inside buf=2
    Xc = around(h["flatten"]) if flatten else set()
    for i, j in Xc:
        if w[2](i, j):
            reads_ok(line(i, j, 1, 0, 2) + line(i, j, 0, 1, 2), Qc)
    # 3. the states of the cells the faces take: the flattened slope of
    # each primitive along the direction (the 4th-order MC slope reads the
    # 2nd-order slopes of the cells beside it, 2 cells out, only inside
    # buf=2), the multidimensional coefficient from the pressure and the
    # 1-D coefficients 1 cell around
    Sx = box(range(i0 - 1, i0 + p.tx + 1), range(j0, j0 + p.ty))
    Sy = box(range(i0, i0 + p.tx), range(j0 - 1, j0 + p.ty + 1))
    for cells, di, dj in ((Sx, 1, 0), (Sy, 0, 1)):
        for i, j in cells:
            if not w[2](i, j):
                continue
            reads = line(i, j, di, dj, 1)
            if limiter == 2:
                for a in (-1, 1):
                    if w[2](i + a * di, j + a * dj):
                        reads += line(i + a * di, j + a * dj, di, dj, 1)
            if flatten:
                reads += line(i, j, 1, 0, 1) + line(i, j, 0, 1, 1)
                reads_ok(line(i, j, 1, 0, 1) + line(i, j, 0, 1, 1), Xc)
            reads_ok(reads, Qc)
    ilo, ihi, jlo, jhi = ng, ng + nx - 1, ng, ng + ny - 1
    # 4. the faces of the tile: the states of the cells on either side,
    # and (not on the last face) the vertex divergences at the face's two
    # corners, inside buf=1, and the state on either side
    fx = {(i, j) for i in range(i0, i0 + p.tx + 1)
          for j in range(j0, j0 + p.ty)
          if ilo <= i <= ihi + 1 and jlo <= j <= jhi}
    fy = {(i, j) for i in range(i0, i0 + p.tx)
          for j in range(j0, j0 + p.ty + 1)
          if jlo <= j <= jhi + 1 and ilo <= i <= ihi}

    def vdiv(i, j):
        return ([(i - a, j - b) for a in (0, 1) for b in (0, 1)]
                if w[1](i, j) else [])

    for i, j in fx:
        reads_ok([(i - 1, j), (i, j)], {c for c in Sx if w[2](*c)})
        if i <= ihi:
            reads_ok(vdiv(i, j) + vdiv(i, j + 1), Qc)
            assert inside(i - 1, j)
    for i, j in fy:
        reads_ok([(i, j - 1), (i, j)], {c for c in Sy if w[2](*c)})
        if j <= jhi:
            reads_ok(vdiv(i, j) + vdiv(i + 1, j), Qc)
            assert inside(i, j - 1)
    # 5. the tile's interior cells: the divergence
    for i in range(i0, i0 + p.tx):
        for j in range(j0, j0 + p.ty):
            if w[0](i, j):
                reads_ok([(i, j), (i + 1, j)], fx)
                reads_ok([(i, j), (i, j + 1)], fy)
    # the halos the plan hands the kernel are these
    assert p.ints()[3:5] == [h["prim"], h["flatten"]] == [4, 2]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nvar", range(4, ctu_kernel.MAXVAR + 1))
def test_rk_shared_memory_fits(dtype, nvar):
    """Every variable count and dtype, with and without flattening, fits
    the 232,448 bytes a block may opt into; the arrays lie one after
    another; two float32 blocks of the solvers' 4 variables share an
    SM."""
    item = torch.empty((), dtype=dtype).element_size()
    for flatten in (False, True):
        p = mol_kernel.rk_plan(200, 136, nvar, dtype, flatten=flatten)
        assert 0 < p.smem <= SMEM_LIMIT
        end = 0
        for name in p.ARRAYS:
            size = p.sizes[name]
            assert p.offsets[name] == (end if size else -1)
            end += size
        assert end * item == p.smem
        assert (p.offsets["xi"] >= 0) == flatten
        if dtype == torch.float32 and nvar == 4:
            assert 2 * p.smem <= SMEM_SM and p.threads == 512


@pytest.mark.parametrize("dtype", DTYPES)
def test_rk_plan_passes_the_kernels_checks(dtype):
    """The plan array each rk launch takes has the length mol_substep.cu
    reads (RK_PLAN_INTS) and passes its rk_plan_ok, for every variable
    count, with and without flattening, on ragged grids."""
    import re

    from pyro2_tpu_torch.util import cuda_build

    text = (cuda_build.CSRC / "mol_substep.cu").read_text()
    n_ints = int(re.search(r"constexpr int RK_PLAN_INTS = (\d+);",
                           text).group(1))
    item = torch.empty((), dtype=dtype).element_size()
    for nx, ny in _rk_grids(dtype):
        for nvar in range(4, ctu_kernel.MAXVAR + 1):
            for flatten in (False, True):
                p = mol_kernel.rk_plan(nx, ny, nvar, dtype, flatten=flatten)
                ints = p.ints()
                assert len(ints) == n_ints
                assert _rk_plan_ok(item, nx, ny, nvar, flatten, ints)


def test_rk_uncovered_variable_order_raises():
    """The rk stage refuses a frame whose conserved variables are out of
    the solvers' order, as the fv4 stage does (A.22)."""
    import copy

    from pyro2_tpu_torch import Pyro

    p = Pyro("compressible_rk", device="cpu")
    p.initialize_problem("quad", inputs_dict={"mesh.nx": 8, "mesh.ny": 8})
    sim = copy.copy(p.sim)
    sim.ivars = copy.copy(sim.ivars)
    sim.ivars.idens, sim.ivars.iener = sim.ivars.iener, sim.ivars.idens
    with pytest.raises(NotImplementedError, match="A.22"):
        mol_kernel.MOLSubstep(sim, "rk")
    assert mol_kernel.MOLSubstep(p.sim, "rk").kind == "rk"


@pytest.mark.parametrize("solver", ["compressible_rk", "compressible_fv4",
                                    "compressible_sdc"])
def test_mol_kernel_args_carry_the_edge_flags(solver):
    """The MOL stages' int array ends with the four domain-edge flags of
    rk's viscosity (ints 21..24, which mol_substep.cu rk_params reads):
    all 1 on a serial grid, 0 on a sharded block's seams; fv4 and sdc,
    whose pipeline reads none, carry zeros.  The plain stage takes the
    same flags."""
    import re

    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.parallel import ShardedSim
    from pyro2_tpu_torch.parallel.mesh_comm import Mesh
    from pyro2_tpu_torch.util import cuda_build

    text = (cuda_build.CSRC / "mol_substep.cu").read_text()
    body = text[text.index("inline Params rk_params"):]
    body = body[:body.index("}")]
    assert re.findall(r"p\.edge_(\w+) = ip\[(\d+)\];", body) == [
        ("xl", "21"), ("xr", "22"), ("yl", "23"), ("yr", "24")]
    p = Pyro(solver, device="cpu")
    p.initialize_problem("quad", inputs_dict={"mesh.nx": 16, "mesh.ny": 16})
    U = p.sim.cc_data.data
    ints, _ = p.sim._step.kernel_args(U, 1e-3)
    rk = solver == "compressible_rk"
    assert len(ints) == 25
    assert ints[21:] == ([1, 1, 1, 1] if rk else [0, 0, 0, 0])
    for coords, want in (((0, 0), [1, 0, 1, 0]), ((1, 1), [0, 1, 0, 1])):
        sh = ShardedSim(solver, p.sim.rp, Mesh((2, 2), "cpu", coords),
                        problem="quad")
        frame = torch.zeros(sh._block_step.shape, dtype=U.dtype)
        ints, _ = sh._block_step.kernel_args(frame, 1e-3)
        assert ints[21:] == (want if rk else [0, 0, 0, 0])
        assert list(sh.local_sim.domain_edges.flags()) == want


# -- the deep smoothing round (mg_deep_smooth) --------------------------------

# deep frames (bx, by, dpx, dpy, wrap): the 1x1 frames of the 1024^2 path
# (Neumann, and periodic: its boxes wrap), a 2x2 and a 1x4 block of 1024^2
# (d 21), and ragged rectangular ones
DEEP_FRAMES = ((1024, 1024, 1, 1, (False, False)),
               (1024, 1024, 1, 1, (True, True)),
               (512, 512, 21, 21, (False, False)),
               (512, 512, 101, 101, (False, False)),
               (1024, 256, 1, 21, (True, False)),
               (96, 40, 5, 1, (False, False)),
               (40, 96, 1, 7, (False, False)), (6, 10, 3, 3, (False, False)))
DEEP_SWEEPS = (0, 1, 10, 50)


def _deep_plan_ok(bx, by, dpx, dpy, wrap, smoother, n_sweeps, item, ints):
    """mg_deep.cu deep_plan_ok, line by line, on the plan's ints."""
    (tx, ty, halo, rounds, iters, threads, smem, gx, gy, bh, bw,
     arrays) = ints
    reach = 2 if smoother == "rbgs" else 1
    want_arrays = {"rbgs": 2, "jacobi": 3, "chebyshev": 4}[smoother]
    want = 1 if n_sweeps == 0 else -(-n_sweeps // max(iters, 1))
    for tiles, tile, dp, b in ((gy, tx, dpx, bx), (gx, ty, dpy, by)):
        nb = tiles - 2 * smk._halo_tiles(dp, tile, halo)
        if tile < 2 or tile % 2 or nb < 1 or (nb - 1) * tile >= b or \
                nb * tile < b:
            return False
    if iters < 0 or (n_sweeps > 0 and iters < 1) or rounds != want or \
            halo < reach * iters + 1 or threads < 32 or threads > 512 or \
            threads % 32 or arrays != want_arrays:
        return False

    def widest(tiles, tile, dp, b, wr):
        F = b + 2 * dp
        most = 0
        for k in range(tiles):
            o0, o1 = smk._owned(k, tiles, tile, dp, b, halo)
            most = max(most, o1 - o0 + 2 * halo if wr else
                       min(F, o1 + halo) - max(0, o0 - halo))
        return most

    if bh < widest(gy, tx, dpx, bx, wrap[0]) or \
            bw < widest(gx, ty, dpy, by, wrap[1]):
        return False
    return smem >= arrays * bh * bw * item


@pytest.mark.parametrize("dtype", DTYPES)
def test_deep_tiles_cover_every_cell_once(dtype):
    """The tiles of the grid the deep kernel launches are even and cover
    the owned block once; with the frame's halo and ghosts, which the tiles
    at its edges own, they cover every frame cell once; and the coarse
    cells of the tiles (the four children of each in one tile) with the
    coarse ghosts of the edge tiles cover the coarse frame once."""
    for bx, by, dpx, dpy, wrap in DEEP_FRAMES:
        for smoother in smk.SMOOTHERS:
            p = smk.deep_plan(bx, by, dpx, dpy, 10, smoother, dtype, wrap)
            assert p.tx % 2 == 0 and p.ty % 2 == 0
            Fx, Fy = bx + 2 * dpx, by + 2 * dpy
            cover = np.zeros((Fx, Fy), dtype=int)
            coarse = np.zeros((bx // 2 + 2, by // 2 + 2), dtype=int)
            nlx = smk._halo_tiles(dpx, p.tx, p.halo)
            nly = smk._halo_tiles(dpy, p.ty, p.halo)
            nbx, nby = p.gy - 2 * nlx, p.gx - 2 * nly
            assert nbx == -(-bx // p.tx) and nby == -(-by // p.ty)
            for ti in range(p.gy):
                for tj in range(p.gx):
                    r0, r1 = smk._owned(ti, p.gy, p.tx, dpx, bx, p.halo)
                    c0, c1 = smk._owned(tj, p.gx, p.ty, dpy, by, p.halo)
                    assert 0 < r1 - r0 and 0 < c1 - c0
                    cover[r0:r1, c0:c1] += 1
                    mx, my = ti - nlx, tj - nly
                    if not (0 <= mx < nbx and 0 <= my < nby):
                        continue            # a tile of the halo
                    I0, J0 = 1 + mx * p.tx // 2, 1 + my * p.ty // 2
                    R0 = 0 if mx == 0 else I0
                    R1 = bx // 2 + 2 if mx == nbx - 1 else I0 + p.tx // 2
                    C0 = 0 if my == 0 else J0
                    C1 = by // 2 + 2 if my == nby - 1 else J0 + p.ty // 2
                    coarse[R0:R1, C0:C1] += 1
                    # the children of the tile's coarse cells are its own
                    for I in range(max(R0, 1), min(R1, bx // 2 + 1)):
                        assert r0 <= dpx + 2 * I - 2 and \
                            dpx + 2 * I - 1 < r1
            assert (cover == 1).all() and (coarse == 1).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("smoother", smk.SMOOTHERS)
@pytest.mark.parametrize("n_sweeps", DEEP_SWEEPS)
def test_deep_halo_covers_a_rounds_reach(n_sweeps, smoother, dtype):
    """The halo is a sub-round's reach (2 cells a red-black sweep, 1 a
    Jacobi or Chebyshev step) and one for the residual; the sub-rounds take
    n_sweeps together, the last the rest; the solvers' 10 red-black sweeps
    take one launch on the 1x1 and 2x2 frames of 1024^2, and 50 more than
    one."""
    for bx, by, dpx, dpy, wrap in DEEP_FRAMES:
        p = smk.deep_plan(bx, by, dpx, dpy, n_sweeps, smoother, dtype, wrap)
        its = p.round_iters()
        assert len(its) == p.rounds and sum(its) == n_sweeps
        assert all(0 < i <= p.iters for i in its) or n_sweeps == 0
        assert p.halo == smk.REACH[smoother] * p.iters + 1
    for bx, dp in ((1024, 1), (512, 21)):
        p = smk.deep_plan(bx, bx, dp, dp, 10, "rbgs", dtype)
        assert p.rounds == 1 and p.halo == 21
    if n_sweeps == 50:
        assert smk.deep_plan(1024, 1024, 1, 1, 50, smoother, dtype).rounds > 1


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("smoother", smk.SMOOTHERS)
def test_deep_shared_memory_fits(smoother, dtype):
    """A block's boxes (v, f, Jacobi's second iterate, Chebyshev's dk, each
    the widest box of the plan's tiles) fit the budget that lets two blocks
    share an SM, at every frame and sweep count; the frames of the 1024^2
    path take enough tiles to fill the card."""
    item = torch.empty((), dtype=dtype).element_size()
    for bx, by, dpx, dpy, wrap in DEEP_FRAMES:
        for n_sweeps in DEEP_SWEEPS:
            p = smk.deep_plan(bx, by, dpx, dpy, n_sweeps, smoother, dtype,
                              wrap)
            assert p.smem == p.arrays * p.bh * p.bw * item
            assert p.smem <= mg_kernel.TILE_SMEM and 2 * p.smem <= SMEM_SM
            assert p.threads == smk.DEEP_THREADS
            if bx >= 512:
                assert p.gx * p.gy >= mg_kernel.TILE_BLOCKS


@pytest.mark.parametrize("dtype", DTYPES)
def test_deep_plan_passes_the_kernels_checks(dtype):
    """The plan array each deep launch takes has the length mg_deep.cu
    reads (DEEP_PLAN_INTS) and passes its deep_plan_ok at every frame,
    smoother and sweep count; a frame that wraps an axis of a block that is
    not a power of 2, or with more than one halo cell, is refused (A.24)."""
    import re

    from pyro2_tpu_torch.util import cuda_build

    text = (cuda_build.CSRC / "mg_deep.cu").read_text()
    n_ints = int(re.search(r"constexpr int DEEP_PLAN_INTS = (\d+);",
                           text).group(1))
    item = torch.empty((), dtype=dtype).element_size()
    for bx, by, dpx, dpy, wrap in DEEP_FRAMES:
        for smoother in smk.SMOOTHERS:
            for n_sweeps in DEEP_SWEEPS:
                ints = smk.deep_plan(bx, by, dpx, dpy, n_sweeps, smoother,
                                     dtype, wrap).ints()
                assert len(ints) == n_ints
                assert _deep_plan_ok(bx, by, dpx, dpy, wrap, smoother,
                                     n_sweeps, item, ints)
    smk.covered(64, 40, 1, 3, [2, 2, 1, 1])
    for args in ((48, 40, 1, 3, [2, 2, 1, 1]), (64, 40, 2, 1, [2, 2, 1, 1]),
                 (64, 24, 1, 1, [1, 1, 2, 2])):
        with pytest.raises(NotImplementedError, match="A.24"):
            smk.covered(*args)


# -- the lm_atm interface stages ----------------------------------------------

def _lm_grids(dtype):
    """Ragged grids: 200x136, one cell, 1024x1000, and 7 x 5 tiles' worth
    with a ragged last tile each way (as the f32 and f64 tiles make them)."""
    p = lm_kernel.plan("lm_states", 1, 1, NG, dtype)
    tx, ty = p.tx, p.ty
    return ((200, 136), (1, 1), (1024, 1000), (7 * tx - 3, 5 * ty - 1),
            (7 * tx, 5 * ty))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("entry", lm_kernel.ENTRIES)
def test_lm_tiles_cover_the_outputs_once(dtype, entry):
    """The grid each lm kernel launches (the plan's ints) has a block for
    each tile, and the tiles cover each output cell exactly once: the
    whole frame for lm_mac (the edge tiles own its zero rows and columns),
    the interior for lm_rho and lm_states."""
    for nx, ny in _lm_grids(dtype):
        p = lm_kernel.plan(entry, nx, ny, NG, dtype)
        assert p.ints()[-2:] == [p.gx, p.gy]
        rows, cols = (nx + 2 * NG, ny + 2 * NG) if entry == "lm_mac" \
            else (nx, ny)
        assert (p.gy - 1) * p.tx < rows <= p.gy * p.tx
        assert (p.gx - 1) * p.ty < cols <= p.gx * p.ty
        owned = np.zeros((nx + 2 * NG, ny + 2 * NG), dtype=int)
        for by in range(p.gy):
            for bx in range(p.gx):
                i0, j0 = p.origin + by * p.tx, p.origin + bx * p.ty
                owned[i0:min(i0 + p.tx, p.origin + rows),
                      j0:min(j0 + p.ty, p.origin + cols)] += 1
        if entry == "lm_mac":
            assert (owned == 1).all()
        else:
            assert (owned[NG:NG + nx, NG:NG + ny] == 1).all()
            assert owned.sum() == nx * ny


def _lm_reads(entry, p, nx, ny, i0, j0):
    """The cells each phase of the lm kernel reads on the tile at (i0, j0):
    {"in": input cells, "fp": first-pass cells, "fc": face cells}, and the
    cells the first pass and the faces compute, by the windows of
    lm_interface.cu (a read under a false window test is not made)."""
    ng = NG
    w = {b: _win(ng, nx, ny, b) for b in (1, 2)}

    def w12(i, j):
        return ng - 1 <= i <= ng + nx + 1 and ng - 1 <= j <= ng + ny + 1

    reads = {"in": set(), "fp": set(), "fc": set()}

    def hats(i, j):
        for c in ((i - 1, j), (i, j - 1), (i, j)):
            if w[2](*c):
                reads["in"].add(c)
                if entry == "lm_rho":
                    reads["in"].add((i, j))     # the face's MAC velocity

    def corr(i, j, kind):
        # du_x, dv_x: (i, j), (i, j+1); dv_y, du_y: (i, j), (i+1, j); rho's
        # dx_corr, dy_corr on buf=2 read the MAC velocities one further
        if not w[2 if entry == "lm_rho" else 1](i, j):
            return
        nb = (i, j + 1) if kind == "y" else (i + 1, j)
        reads["fp"] |= {(i, j), nb}
        reads["in"] |= {(i, j), nb} if entry == "lm_rho" else {(i, j)}
        if entry == "lm_rho":
            reads["in"] |= {(i + 1, j), (i, j + 1)}

    ring = {(a, b) for a in range(i0 - 1, i0 + p.tx + 1)
            for b in range(j0 - 1, j0 + p.ty + 1)}
    for a, b in ring:
        if w12(a, b):
            hats(a, b)
    if entry == "lm_mac":
        for i in range(i0, i0 + p.tx):
            for j in range(j0, j0 + p.ty):
                if w12(i, j):
                    hats(i, j)
                    corr(i - 1, j, "y")
                    corr(i, j, "y")
                    corr(i, j - 1, "x")
                    corr(i, j, "x")
        return reads, ring, set()
    xf = {(a, b) for a in range(i0, i0 + p.tx + 1)
          for b in range(j0, j0 + p.ty)}
    yf = {(a, b) for a in range(i0, i0 + p.tx)
          for b in range(j0, j0 + p.ty + 1)}
    for a, b in xf | yf:
        hats(a, b)
    for a, b in xf:
        corr(a - 1, b, "y")
        corr(a, b, "y")
        if w12(a, b):
            reads["in"].add((a, b))
    for a, b in yf:
        corr(a, b - 1, "x")
        corr(a, b, "x")
        if w12(a, b):
            reads["in"].add((a, b))
    for i in range(i0, i0 + p.tx):
        for j in range(j0, j0 + p.ty):
            if ng <= i < ng + nx and ng <= j < ng + ny:
                reads["fc"] |= {(i, j), (i + 1, j), (i, j + 1)}
                reads["in"] |= {(i, j), (i + 1, j), (i, j + 1)}
    return reads, ring, xf | yf


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("entry", lm_kernel.ENTRIES)
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_lm_phase_reads_stay_inside_the_boxes(dtype, entry, where):
    """Every phase of an lm kernel, on the tile at the first corner of its
    outputs, inside them or at their last (ragged) corner: the inputs it
    reads lie in the frame and in the box of the plan's halos (2 below the
    tile, 1 above; 2 for rho), the first-pass values in the tile's ring,
    and the face values among the faces the block computed
    (lm_interface.cu: a read under a false window test is not made)."""
    nx, ny = 67, 145
    p = lm_kernel.plan(entry, nx, ny, NG, dtype)
    assert p.gx >= 3 and p.gy >= 3
    by, bx = {"first": (0, 0), "middle": (p.gy // 2, p.gx // 2),
              "last": (p.gy - 1, p.gx - 1)}[where]
    i0, j0 = p.origin + by * p.tx, p.origin + bx * p.ty
    reads, ring, faces = _lm_reads(entry, p, nx, ny, i0, j0)
    qx, qy = nx + 2 * NG, ny + 2 * NG
    lo, hi = p.lo, p.hi
    for i, j in reads["in"]:
        assert 0 <= i < qx and 0 <= j < qy, (i, j)
        assert i0 - lo <= i < i0 + p.tx + hi, (i, j, "rows")
        assert j0 - lo <= j < j0 + p.ty + hi, (i, j, "columns")
    assert reads["fp"] <= ring
    assert reads["fc"] <= faces
    # the halos are as deep as the reads need, and no deeper
    rows = [i for i, _ in reads["in"]]
    if where == "middle":
        assert min(rows) == i0 - lo and max(rows) == i0 + p.tx + hi - 1
    assert p.ints()[3:5] == [2, 2 if entry == "lm_rho" else 1]
    assert lm_kernel.NG_MIN == lo + 1 <= NG


def _lm_plan_ok(item, entry, nx, ny, ng, ints):
    """lm_interface.cu lm_plan_ok, line by line, on a plan's ints."""
    tx, ty, threads, lo, hi, in_, fp, fc, smem, gx, gy = ints
    e = lm_kernel.ENTRIES.index(entry)
    n_in, n_first, n_faces = (9, 5, 11)[e], (6, 2, 6)[e], (0, 2, 4)[e]
    if nx < 1 or ny < 1 or threads != 256 or \
            (tx, ty) != lm_kernel.TILES[entry] or lo != 2 or \
            hi != (2 if entry == "lm_rho" else 1) or ng < 3:
        return False
    rows, cols = (nx + 2 * ng, ny + 2 * ng) if entry == "lm_mac" \
        else (nx, ny)
    if gx < 1 or gy < 1 or (gx - 1) * ty >= cols or gx * ty < cols or \
            (gy - 1) * tx >= rows or gy * tx < rows:
        return False
    nin = n_in * (tx + lo + hi) * (ty + lo + hi)
    nfp = n_first * (tx + 2) * (ty + 2)
    nfc = n_faces * (tx + 1) * (ty + 1)
    return (in_ == 0 and fp == nin and fc == nin + nfp and
            smem >= (nin + nfp + nfc) * item)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lm_shared_memory_fits(dtype):
    """Each entry's boxes fit the 232,448 bytes a block may opt into and as
    many blocks share an SM as the kernel is compiled for (four float32
    lm_states blocks, else two), with the planes where the kernel's checks
    want them; the tiles are those lm_interface.cu compiles (LmTile)."""
    import re

    from pyro2_tpu_torch.util import cuda_build

    text = (cuda_build.CSRC / "lm_interface.cu").read_text()
    assert "tx = E == STATES ? 8 : 16;" in text
    assert "ty = E == MAC ? 32 : 64;" in text
    assert re.search(r"threads = 256;\s+static constexpr int blocks = E == "
                     r"STATES && sizeof\(T\) == 4 \? 4 : 2;", text)
    item = torch.empty((), dtype=dtype).element_size()
    tiles = {"lm_mac": (16, 32), "lm_rho": (16, 64), "lm_states": (8, 64)}
    for entry in lm_kernel.ENTRIES:
        p = lm_kernel.plan(entry, 1024, 1024, NG, dtype)
        assert (p.tx, p.ty) == lm_kernel.TILES[entry] == tiles[entry]
        assert 0 < p.smem <= SMEM_LIMIT
        assert p.blocks == (4 if (entry, dtype) == ("lm_states",
                                                    torch.float32) else 2)
        assert p.blocks * p.smem <= SMEM_SM
        assert p.threads == lm_kernel.THREADS == 256
        hi = 2 if entry == "lm_rho" else 1
        assert p.sizes == {
            "in": lm_kernel.PLANES[entry] * (p.tx + 2 + hi) * (p.ty + 2 + hi),
            "fp": lm_kernel.FIRST[entry] * (p.tx + 2) * (p.ty + 2),
            "fc": lm_kernel.FACES[entry] * (p.tx + 1) * (p.ty + 1)}
        assert p.smem == item * sum(p.sizes.values())
        assert _lm_plan_ok(item, entry, 1024, 1024, NG, p.ints())


@pytest.mark.parametrize("dtype", DTYPES)
def test_lm_plan_passes_the_kernels_checks(dtype):
    """The plan array each lm launch takes has the length lm_interface.cu
    reads (LM_PLAN_INTS) and passes its lm_plan_ok for every entry on
    ragged grids; another tile, a halo one cell short or long, a grid one
    tile short, another block's threads or another layout of the shared
    memory fail it."""
    import re

    from pyro2_tpu_torch.util import cuda_build

    text = (cuda_build.CSRC / "lm_interface.cu").read_text()
    n_ints = int(re.search(r"constexpr int LM_PLAN_INTS = (\d+);",
                           text).group(1))
    item = torch.empty((), dtype=dtype).element_size()
    for nx, ny in _lm_grids(dtype):
        for entry in lm_kernel.ENTRIES:
            ints = lm_kernel.plan(entry, nx, ny, NG, dtype).ints()
            assert len(ints) == n_ints
            assert _lm_plan_ok(item, entry, nx, ny, NG, ints)
            for k, d in ((0, -1), (1, 1), (3, -1), (4, -1), (3, 1), (4, 1),
                         (9, -1), (10, -1), (2, 1), (6, 1), (7, -1),
                         (8, -item)):
                bad = list(ints)
                bad[k] += d
                assert not _lm_plan_ok(item, entry, nx, ny, NG, bad)
    assert not _lm_plan_ok(item, "lm_mac", 8, 8, 2, lm_kernel.plan(
        "lm_mac", 8, 8, 2, dtype).ints())


@pytest.mark.parametrize("ng", [0, 1, 2])
def test_lm_uncovered_frames_raise(ng):
    """A frame with fewer ghosts than the input halo below the (lo-1,
    hi+2) window needs raises, naming ROADMAP A.25; lm_atm's frame (4
    ghosts) is covered in both dtypes."""
    with pytest.raises(NotImplementedError, match="A.25"):
        lm_kernel.covered(ng, torch.float32)
    for dtype in DTYPES:
        lm_kernel.covered(4, dtype)
