"""The port's collective accounting (pyro2_tpu_torch/parallel/accounting.py,
the recorder of parallel/mesh_comm.py) and halo_stats (parallel/overlap.py)
against the JAX package's, as tests/test_parallel.py's
test_collective_accounting and test_ppermute_collapse check them.

The programs run once on gloo ranks of a 2x2 and a 1x4 mesh
(torch_rank_programs.accounting, one launch each), in float64; the JAX
tallies come from the same programs traced on a mesh of the same shape of
conftest's fake CPU devices.  The counts differ from JAX's where the
accounting module says they do: the stacked fill sends 2 messages per
split axis where JAX sends 2 nvar (the bytes are equal), an axis of one
block counts nothing, and a data-dependent loop counts every trip."""

import functools
import importlib

import numpy as np
import pytest
import torch

import torch_rank_programs as trp

from pyro2_tpu.parallel import make_mesh as jmake_mesh
from pyro2_tpu.util.runparams import RuntimeParameters as JRP
from pyro2_tpu_torch.parallel import (ShardedCompressible, collective_stats,
                                      halo_stats, launch, make_mesh)
from pyro2_tpu_torch.parallel.mesh_comm import Mesh
from pyro2_tpu_torch.util.runparams import RuntimeParameters

N = 64
QUAD = {"mesh.nx": N, "mesh.ny": N, "compressible.cvisc": 0.1,
        **{f"mesh.{e}boundary": "outflow" for e in ("xl", "xr", "yl", "yr")}}
SHAPES = ((2, 2), (1, 4))


def _params(pkg):
    rp = (RuntimeParameters if pkg == "pyro2_tpu_torch" else JRP)()
    rp.load_params(f"{pkg}/_defaults")
    rp.load_params(f"{pkg}/solvers/compressible/_defaults")
    pm = importlib.import_module(f"{pkg}.solvers.compressible.problems.quad")
    for k, v in {**pm.PROBLEM_PARAMS, "driver.verbose": 0, "vis.dovis": 0,
                 "io.do_io": 0, **QUAD}.items():
        rp.set_param(k, v, no_new=False)
    return rp


def _rhs():
    x = (np.arange(N) + 0.5) / N
    return np.sin(2 * np.pi * x)[:, None] * np.cos(2 * np.pi * x)[None, :]


@pytest.fixture(scope="module")
def stats():
    """{mesh shape: rank 0's tallies}; every rank's tallies equal."""
    out = {}
    for shape in SHAPES:
        ranks = launch.run(trp.accounting, shape, _params(
            "pyro2_tpu_torch").params, "quad", N, _rhs(), device="cpu",
            timeout=300)
        for res in ranks[1:]:
            assert res == ranks[0]
        out[shape] = ranks[0]
    return out


@functools.lru_cache(maxsize=None)
def _jax(shape):
    """JAX's collective_stats of the quad step and its dt, and its
    halo_stats, on a mesh of this shape."""
    from pyro2_tpu.parallel.accounting import collective_stats as jstats
    from pyro2_tpu.parallel.overlap import halo_stats as jhalo
    from pyro2_tpu.parallel.sharded import ShardedCompressible as JSC

    sc = JSC(_params("pyro2_tpu"), jmake_mesh(shape=shape), problem="quad")
    U = sc.init_interior()
    return (jstats(lambda u: sc._step(u, 0.0, 0.002), U),
            jstats(sc._dt_fn, U), jhalo(sc))


class TestCollectiveStats:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_step_ppermutes_and_bytes(self, stats, shape):
        """The quad step: 2 ppermutes per split axis and nothing else, the
        bytes JAX counts on the same mesh shape (4 2 ng (qx + qy) itemsize
        on 2x2).  Fails if a ppermute pair is counted once or an axis of
        one block counts."""
        st = stats[shape]["step"]
        splits = sum(p > 1 for p in shape)
        assert st["ppermute"]["count"] == 2 * splits
        jst = _jax(shape)[0]
        assert st["ppermute"]["bytes"] == jst["ppermute"]["bytes"]
        assert st["total_bytes"] == jst["total_bytes"] == \
            st["ppermute"]["bytes"]
        assert set(st) == {"ppermute", "total_bytes", "dynamic_trip"}
        assert not st["dynamic_trip"]
        assert jst["ppermute"]["count"] == 4 * 2 * splits
        if shape == (2, 2):
            qx = qy = N // 2 + 8
            assert st["total_bytes"] == 4 * 2 * 4 * (qx + qy) * 8

    @pytest.mark.parametrize("shape", SHAPES)
    def test_dt_pmins(self, stats, shape):
        """compute_dt: one pmin a split axis (2 on 2x2, as JAX counts),
        after the fill's ppermutes."""
        st = stats[shape]["dt"]
        splits = sum(p > 1 for p in shape)
        assert st["pmin"] == {"count": splits, "bytes": 8 * splits}
        assert st["ppermute"] == stats[shape]["step"]["ppermute"]
        if shape == (2, 2):
            assert _jax(shape)[1]["pmin"]["count"] == 2

    @pytest.mark.parametrize("shape", SHAPES)
    def test_overlap_sends_what_the_plain_step_sends(self, stats, shape):
        assert stats[shape]["overlap"] == stats[shape]["step"]

    @pytest.mark.parametrize("shape", SHAPES)
    def test_deep_cycle_collapses_the_ppermutes(self, stats, shape):
        """One sharded cycle: comm_mode "deep" makes at least 10x fewer
        ppermutes than "sweep" (JAX's test_ppermute_collapse), and both
        gather the coarse problem."""
        deep, sweep = stats[shape]["deep"], stats[shape]["sweep"]
        assert deep["ppermute"]["count"] * 10 < sweep["ppermute"]["count"]
        assert deep["all_gather"]["count"] >= 1
        assert not deep["dynamic_trip"] and not sweep["dynamic_trip"]

    @pytest.mark.parametrize("shape", SHAPES)
    def test_solve_loop_is_dynamic(self, stats, shape):
        """A whole solve: the cycle loop's collectives mark the tally
        dynamic and count every trip (one psum of the norms a cycle and
        split axis, the cycle's ppermutes each time)."""
        st, cyc = stats[shape]["solve"], stats[shape]["deep"]
        assert st["dynamic_trip"]
        splits = sum(p > 1 for p in shape)
        cycles = st["psum"]["count"] // splits
        assert cycles > 1 and st["psum"]["count"] == cycles * splits
        assert st["ppermute"]["count"] == cycles * cyc["ppermute"]["count"]

    def test_one_block_counts_nothing(self):
        """On a 1x1 mesh nothing is exchanged: an empty tally."""
        sc = ShardedCompressible(_params("pyro2_tpu_torch"),
                                 make_mesh(device="cpu"), problem="quad")
        U = sc.init_interior()
        st = collective_stats(sc.step, U, 0.0, 0.002)
        assert st == {"total_bytes": 0, "dynamic_trip": False}


class TestHaloStats:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_against_jax(self, stats, shape):
        """JAX's keys and values, but ppermutes_per_step (2 per split axis
        for the stacked fill, JAX 2 nvar); the bytes equal the recorded
        ppermute bytes of a step."""
        hs, jhs = stats[shape]["halo"], _jax(shape)[2]
        assert set(hs) == set(jhs)
        for k in jhs:
            if k != "ppermutes_per_step":
                assert hs[k] == jhs[k], k
        splits = sum(p > 1 for p in shape)
        assert hs["ppermutes_per_step"] == 2 * splits
        assert jhs["ppermutes_per_step"] == 4 * 2 * splits
        assert hs["halo_bytes_per_step"] == \
            stats[shape]["step"]["ppermute"]["bytes"]
        assert 0.0 < hs["core_fraction"] < 1.0

    def test_itemsize_follows_the_dtype(self):
        mesh = Mesh((2, 2), "cpu", (0, 0))
        h64 = halo_stats(ShardedCompressible(
            _params("pyro2_tpu_torch"), mesh, problem="quad",
            dtype=torch.float64))
        h32 = halo_stats(ShardedCompressible(
            _params("pyro2_tpu_torch"), mesh, problem="quad",
            dtype=torch.float32))
        assert h64["halo_bytes_per_step"] == 2 * h32["halo_bytes_per_step"]
        assert h64["block"] == [32, 32] and h64["mesh"] == [2, 2]
