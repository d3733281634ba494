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
        plan = mg_kernel.tile_plan(n, nsmooth, dtype)
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
