"""The tile schedule of the multigrid descent kernel (mg_vcycle.cu k_down),
run in plain PyTorch on the CPU (test_torch_mg_up_tiles.py's tile_round):
for each tile of a plan and each round, the box of the tile and its halo is
built from the frame (zeros for a zero guess in the first round), the
round's half-sweeps of the plain red-black stencil run on it while the
cells that are still exact shrink, and the tile's cells are written with
the ghosts that mirror them; in the last round the residual of the tile's
cells, from the box, is restricted into the tile's coarse cells of fc,
whose ghosts are zero.  The smoothed v (its ghosts as `put` writes them)
and fc must equal `mg_kernel.down_plain` bit for bit, the cavity's ZERO
edge (sign 0) included; a halo one cell short must not reach."""

import math

import numpy as np
import pytest
import torch

from pyro2_tpu_torch.multigrid import mg_kernel
from test_torch_mg_up_tiles import make_mg, put_ghosts, same_bits, tile_round


def _down_schedule(mg, op, level, v, f, tile, rounds, halo=None):
    """mg_down's result computed tile by tile as k_down computes it (v None:
    a zero guess); `halo` replaces the rounds' 2 iters + 1."""
    g, gc = mg.grids[level], mg.grids[level - 1]
    n = g.nx
    cur = torch.zeros_like(f) if v is None else v
    fc = torch.zeros((gc.qx, gc.qy), dtype=f.dtype)
    for k, iters in enumerate(rounds):
        new = cur.clone()
        for ti in range(1, n + 1, tile):
            for tj in range(1, n + 1, tile):
                B, r = tile_round(mg, op, level, cur, f, ti, tj, tile, iters,
                                  halo)
                new[ti:ti + tile, tj:tj + tile] = B
                if k == len(rounds) - 1:
                    # the four children in restrict_array's order
                    I0, J0 = (ti + 1) // 2, (tj + 1) // 2
                    fc[I0:I0 + tile // 2, J0:J0 + tile // 2] = 0.25 * (
                        ((r[0::2, 0::2] + r[1::2, 0::2]) + r[0::2, 1::2]) +
                        r[1::2, 1::2])
        cur = new
    return put_ghosts(mg, level, cur), fc


CASES = [(op, edge, dtype) for op in ("const", "vc", "general")
         for edge in ("neumann", "periodic", "dirichlet", "lm_atm", "cavity")
         if (edge != "lm_atm" or op == "vc") and
         (edge != "cavity" or op == "const")
         for dtype in (torch.float64, torch.float32)]

# (n, nsmooth, a tile and the iterations of its rounds): the level whole
# in one tile, 2^2 tiles, rounds of 20, 20 and 10 on 16^2 tiles, and
# tiles whose boxes stay inside the level at 128^2
SCHEDULES = ((4, 0, 4, [0]), (8, 1, 2, [1]), (16, 10, 4, [10]),
             (32, 50, 16, [20, 20, 10]), (128, 10, 64, [10]))


@pytest.mark.parametrize("op,edge,dtype", CASES)
def test_down_tiles_match_the_plain_descent(op, edge, dtype):
    """For every schedule, from a guess and from a zero guess, with the
    schedule's tiles and with the plan tile_plan makes (its tile, halo and
    rounds as the kernel takes them): v with its ghosts and the restricted
    residual bit for bit as down_plain gives them."""
    rng = np.random.default_rng(3)
    for n, nsmooth, tile, rounds in SCHEDULES:
        mg = make_mg(op, n, edge, dtype)
        mg.nsmooth = nsmooth
        level = mg.nlevels - 1
        g = mg.grids[level]
        v = torch.as_tensor(0.1 * rng.standard_normal((g.qx, g.qy)),
                            dtype=dtype)
        f = torch.as_tensor(rng.standard_normal((g.qx, g.qy)), dtype=dtype)
        plan = mg_kernel.tile_plan(n, nsmooth, dtype, op)
        assert plan.halo == 2 * plan.iters + 1
        for guess in (v, None):
            ref_v, ref_fc = mg_kernel.down_plain(mg, level, guess, f)
            for t, rs in ((tile, rounds), (plan.tile, plan.round_iters())):
                got_v, got_fc = _down_schedule(mg, op, level, guess, f, t,
                                               rs)
                assert same_bits(got_v, ref_v), (n, t, rs, guess is None)
                assert same_bits(got_fc, ref_fc), (n, t, rs, guess is None)


@pytest.mark.parametrize("op", ["const", "general"])
def test_a_halo_one_cell_short_does_not_reach(op):
    """A halo of 2 iters (one cell short of the residual's ring) leaves a
    cell the restriction reads stale: the schedule sees it."""
    mg = make_mg(op, 32, "dirichlet", torch.float64)
    mg.nsmooth = 3
    level = mg.nlevels - 1
    g = mg.grids[level]
    rng = np.random.default_rng(4)
    f = torch.as_tensor(rng.standard_normal((g.qx, g.qy)))
    _down_schedule(mg, op, level, None, f, 8, [3], halo=7)
    with pytest.raises(AssertionError, match="the halo does not reach"):
        _down_schedule(mg, op, level, None, f, 8, [3], halo=6)


@pytest.mark.parametrize("op,edge,dtype", CASES)
def test_down_plan_tiles_of_the_register_smoother_match(op, edge, dtype):
    """The tile side the constant operator's plan takes at 4096^2 and
    2048^2 in both dtypes (64, halo 21, one round at nsmooth 10: the box
    of v and f no longer bounds the float64 tile) at 128^2, which holds
    2^2 of them: from a guess
    and from a zero guess, v with its ghosts and the restricted residual
    bit for bit as down_plain gives them, for every operator and edge
    kind."""
    plan = mg_kernel.tile_plan(4096, 10, dtype)
    assert plan.tile == mg_kernel.tile_plan(2048, 10, dtype).tile == 64
    assert (plan.halo, plan.round_iters()) == (21, [10])
    n = 128
    rng = np.random.default_rng(19)
    mg = make_mg(op, n, edge, dtype)
    mg.nsmooth = 10
    level = mg.nlevels - 1
    g = mg.grids[level]
    v = torch.as_tensor(0.1 * rng.standard_normal((g.qx, g.qy)), dtype=dtype)
    f = torch.as_tensor(rng.standard_normal((g.qx, g.qy)), dtype=dtype)
    for guess in (v, None):
        ref_v, ref_fc = mg_kernel.down_plain(mg, level, guess, f)
        got_v, got_fc = _down_schedule(mg, op, level, guess, f, plan.tile,
                                       plan.round_iters())
        assert same_bits(got_v, ref_v), guess is None
        assert same_bits(got_fc, ref_fc), guess is None


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tile_plan_counts_the_box_of_v_alone(dtype):
    """TilePlan of the constant operator's 64^2 tiles: no box of f beside
    the box of v -- shared memory holds each thread's slots of 2 TILE_ROWS
    + 1 values of v and f, v's cells staying in its registers -- and every
    pair of the box's columns over every run of TILE_ROWS rows has its
    thread; f64 at 4096^2, nsmooth 10 takes 64^2 tiles, halo 21, one round
    (a box of v and f held 32^2); every plan's shared memory fits the
    card's limit for a block and for the blocks an SM the kernels are built
    for; the small levels still keep TILE_BLOCKS tiles.  Smaller tiles and
    the coefficient operators keep their boxes of v and f."""
    item = torch.empty((), dtype=dtype).element_size()
    rows = mg_kernel.TILE_ROWS[dtype]
    p = mg_kernel.tile_plan(4096, 10, dtype)
    assert (p.tile, p.halo, p.rounds, p.iters) == (64, 21, 1, 10)
    for k in range(2, 14):
        n = 2 ** k
        for nsmooth in (0, 1, 10, 50):
            p = mg_kernel.tile_plan(n, nsmooth, dtype)
            w = p.tile + 2 * p.halo
            if n >= mg_kernel.TILE_MIN * math.isqrt(mg_kernel.TILE_BLOCKS):
                assert p.tiles ** 2 >= mg_kernel.TILE_BLOCKS
            if p.tile == mg_kernel.TILE_MAX:
                assert p.rows == rows
                assert p.smem == 2 * p.threads * (2 * rows + 1) * item
                assert p.threads == mg_kernel.tile_threads(w, dtype)
                assert p.threads >= (w // 2) * -(-w // rows)
                assert p.threads % 32 == 0
                assert p.threads <= mg_kernel.TILE_THREADS[dtype]
                assert p.smem <= mg_kernel.SMEM_BLOCK
                assert mg_kernel.TILE_SM_BLOCKS[dtype] * (p.smem + 1024) <= \
                    mg_kernel.SMEM_SM
            for q in (p, mg_kernel.tile_plan(n, nsmooth, dtype, "vc"),
                      mg_kernel.tile_plan(n, nsmooth, dtype, "general")):
                if q.tile == mg_kernel.TILE_MAX and q is p:
                    continue
                wq = q.tile + 2 * q.halo
                assert q.rows == 0 and q.threads == mg_kernel.BOX_THREADS
                assert q.smem == 2 * wq * wq * item <= mg_kernel.TILE_SMEM
