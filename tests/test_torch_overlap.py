"""The port's overlapped sharded step (pyro2_tpu_torch/parallel/overlap.py)
against the plain sharded step, as tests/test_parallel.py's TestOverlap
checks JAX's: bit for bit.

Each case starts from its blockwise initial state and takes 2 steps in
float64, plain and overlapped, on gloo ranks of a 2x2 and a 1x4 mesh of
64^2 (one launch each: torch_rank_programs.overlapped; the 1x4 blocks are
64 x 16, exactly 4 ng wide) and on the 1x1 mesh in this process.  Every
case and mesh: equal by bits.  The plain step on a band computes each
cell with the operations the whole block's step does (the CPU tensor ops
of these configurations give shape-independent bits), and the card's
kernels compute every cell with the same code."""

import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_rank_programs as trp

from pyro2_tpu_torch.parallel import (ShardedCompressible, ShardedSWE,
                                      build_overlapped_step, halo_stats,
                                      launch, make_mesh)
from pyro2_tpu_torch.parallel.mesh_comm import Mesh
from pyro2_tpu_torch.util.runparams import RuntimeParameters

SOLVER = {"ShardedCompressible": "compressible", "ShardedSWE": "swe"}


def _bcs(kind):
    return {f"mesh.{e}boundary": kind for e in ("xl", "xr", "yl", "yr")}


def _case(cls, problem, overrides, dt, n=64):
    return {"cls": cls, "problem": problem, "steps": 2, "dt": dt,
            "overrides": {"mesh.nx": n, "mesh.ny": n, **overrides}}


CASES = {
    "advect_periodic": _case("ShardedCompressible", "advect",
                             _bcs("periodic"), 0.002),
    # block-gated solid clamps and domain-edge viscosity in the bands
    "advect_reflect": _case("ShardedCompressible", "advect",
                            _bcs("reflect"), 0.002),
    # shocks across the seams, and the seam density floor in the bands'
    # input
    "quad_floor": _case("ShardedCompressible", "quad",
                        {**_bcs("outflow"), "compressible.cvisc": 0.1,
                         "compressible.small_dens": 0.2}, 0.001),
    # gravity: the gated source fill on each band's sides
    "rt_reflect_y": _case("ShardedCompressible", "rt",
                          {"mesh.xlboundary": "periodic",
                           "mesh.xrboundary": "periodic",
                           "mesh.ylboundary": "reflect",
                           "mesh.yrboundary": "reflect",
                           "mesh.xmax": 1.0, "mesh.ymax": 1.0}, 0.001),
    "swe_quad": _case("ShardedSWE", "quad", _bcs("outflow"), 0.001),
}
NAMES = list(CASES)
SHAPES = ((1, 1), (2, 2), (1, 4))


def _params(case):
    solver = SOLVER[case["cls"]]
    rp = RuntimeParameters()
    rp.load_params("pyro2_tpu_torch/_defaults")
    rp.load_params(f"pyro2_tpu_torch/solvers/{solver}/_defaults")
    pm = importlib.import_module(
        f"pyro2_tpu_torch.solvers.{solver}.problems.{case['problem']}")
    for k, v in {**getattr(pm, "PROBLEM_PARAMS", {}), "driver.verbose": 0,
                 "vis.dovis": 0, "io.do_io": 0,
                 **case["overrides"]}.items():
        rp.set_param(k, v, no_new=False)
    return rp


@pytest.fixture(scope="module")
def runs():
    """{mesh shape: {case: rank 0's plain and overlapped states}}."""
    cases = [{**c, "params": _params(c).params} for c in CASES.values()]
    out = {(1, 1): dict(zip(NAMES, launch.to_host(trp.overlapped(
        make_mesh(device="cpu"), cases))))}
    for shape in SHAPES[1:]:
        ranks = launch.run(trp.overlapped, shape, cases, device="cpu",
                           timeout=300)
        out[shape] = dict(zip(NAMES, ranks[0]))
    return out


class TestOverlappedBits:
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("name", NAMES)
    def test_equals_the_plain_step(self, runs, name, shape):
        """Fails if a band drops the block's high domain edge (its
        viscosity then reads the ghosts), if the bands read the block
        without its seam floor, or if a band takes the wrong slice of the
        block.  A band's wall clamps change no rim cell (the states mirror
        at a wall, and the inner side lies 2 ng from the rim), so
        test_band_flags holds the flags themselves."""
        res = runs[shape][name]
        assert np.isfinite(res["plain"]).all()
        np.testing.assert_array_equal(res["overlap"], res["plain"])
        np.testing.assert_array_equal(res["plain"],
                                      runs[(1, 1)][name]["plain"])


def _block(name, shape, coords, **kw):
    case = CASES[name]
    cls = ShardedCompressible if case["cls"] == "ShardedCompressible" \
        else ShardedSWE
    return cls(_params(case), Mesh(shape, "cpu", coords),
               problem=case["problem"], dtype=torch.float64, **kw)


class TestOverlapPieces:
    def test_core_reads_no_ghost(self):
        """The block step on the zero-ghost pad gives the plain step's
        core cells (at least ng from every block edge), finite; only the
        rim differs."""
        sc = _block("quad_floor", (1, 1), (0, 0))
        ng = sc.ng
        U = sc.init_interior()
        core = sc._interior(sc._block_step(F.pad(U, (ng,) * 4), 0.0, 1e-3))
        ref = sc.step(U, 0.0, 1e-3)
        inner = (slice(None), slice(ng, -ng), slice(ng, -ng))
        assert torch.isfinite(core[inner]).all()
        assert torch.equal(core[inner], ref[inner])
        assert not torch.equal(core, ref)

    @pytest.mark.parametrize("coords", [(0, 0), (1, 1), (0, 1)])
    def test_band_flags(self, coords):
        """Each band keeps the block's solid and domain-edge flags on its
        outer sides and is a seam (0) on its inner side, on every block of
        a 2x2 reflect mesh."""
        sc = _block("advect_reflect", (2, 2), coords, overlap=True)
        own = (coords[0] == 0, coords[0] == 1, coords[1] == 0,
               coords[1] == 1)
        keeps = ((1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 0), (1, 1, 0, 1))
        for band, keep in zip(sc._overlapped.bands, keeps):
            want = tuple(int(o and k) for o, k in zip(own, keep))
            assert band.sim.domain_edges.flags() == want
            solid = band.sim.solid
            assert (solid.xl, solid.xr, solid.yl, solid.yr) == want
            g = band.sim.cc_data.grid
            assert g.dx == sc.local_grid.dx and g.dy == sc.local_grid.dy

    def test_band_grids_are_global_windows(self):
        """A band's coordinates are the global grid's at its cells."""
        sc = _block("advect_reflect", (2, 2), (1, 0), overlap=True)
        lg = sc.local_grid
        xhi = sc._overlapped.bands[1].sim.cc_data.grid
        ylo = sc._overlapped.bands[2].sim.cc_data.grid
        assert np.array_equal(xhi.x, lg.x[lg.nx - 8:])
        assert np.array_equal(ylo.y, lg.y[:ylo.qy])

    def test_swe_builds(self):
        ss = _block("swe_quad", (1, 1), (0, 0), overlap=True)
        assert len(ss._overlapped.bands) == 4
        assert halo_stats(ss)["ppermutes_per_step"] == 0


class TestOverlapRefusals:
    def test_small_block_rejected(self):
        """Blocks of 64 x 8 < 4 ng (JAX's test_small_block_rejected)."""
        with pytest.raises(ValueError, match="overlapped"):
            _block("advect_periodic", (1, 8), (0, 0), overlap=True)
        sc = _block("advect_periodic", (1, 8), (0, 0))
        with pytest.raises(ValueError, match="overlapped"):
            build_overlapped_step(sc)

    def test_ext_bc_rejected(self):
        case = _case("ShardedCompressible", "rt",
                     {"mesh.xlboundary": "periodic",
                      "mesh.xrboundary": "periodic",
                      "mesh.ylboundary": "hse", "mesh.yrboundary": "hse",
                      "mesh.ymax": 3.0}, 0.001)
        with pytest.raises(ValueError, match="overlapped"):
            ShardedCompressible(_params(case), make_mesh(device="cpu"),
                                problem="rt", overlap=True)

    def test_spherical_rejected(self):
        case = _case("ShardedCompressible", "advect",
                     {**_bcs("outflow"), "mesh.grid_type": "SphericalPolar",
                      "mesh.xmin": 0.5, "mesh.xmax": 1.0,
                      "mesh.ymin": 0.7853981633974483,
                      "mesh.ymax": 2.356194490192345,
                      "compressible.riemann": "CGF"}, 0.001)
        with pytest.raises(ValueError, match="overlapped"):
            ShardedCompressible(_params(case), make_mesh(device="cpu"),
                                problem="advect", overlap=True)
