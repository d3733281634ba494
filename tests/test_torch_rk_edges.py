"""The domain-edge flags of the port's rk stage increment, and the gap they
close against the JAX package's sharded rk.

pyro2_tpu's rk fluxes call the artificial viscosity without the block's
edge flags, so every block of its ShardedCompressibleRK zeros the
viscosity on its own high faces, seams included, and its sharded run
departs from its own serial solver wherever the flow compresses across a
seam.  The port's rk stage takes the block's flags (plain stage and
`k_rk`'s ints 21..24), so its sharded run is its serial run by bits.

* JAX's sharded rk on quad 32^2 (outflow, cvisc 0.1), 2x2, one step at dt
  1e-3, differs from JAX's serial step by more than 1e-6 of max|U| at the
  seam cells: the reference behaviour this slice does not follow;
* the port's sharded rk on gloo ranks of the same mesh equals the port's
  serial step by bits, and JAX's serial step within 1e-12 of max|U|;
* one stage increment on each block of a 2x2 split, its frame the window
  of the serial filled frame, equals the serial increment by bits; with
  the block's seam flags forced to 1 it does not.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import torch_rank_programs as trp

from pyro2_tpu.parallel import make_mesh as jmake_mesh
from pyro2_tpu.parallel.sharded_mol import \
    ShardedCompressibleRK as JShardedRK
from pyro2_tpu.util.runparams import RuntimeParameters as JRP
from pyro2_tpu_torch.parallel import ShardedCompressibleRK, launch
from pyro2_tpu_torch.parallel.mesh_comm import Mesh
from pyro2_tpu_torch.solvers.compressible.simulation import DomainEdges
from pyro2_tpu_torch.util.runparams import RuntimeParameters

N, DT = 32, 1e-3
QUAD = {"mesh.nx": N, "mesh.ny": N, "compressible.cvisc": 0.1,
        **{f"mesh.{e}boundary": "outflow" for e in ("xl", "xr", "yl", "yr")}}
# the cells on either side of the 2x2 mesh's seams (x and y index 15, 16)
SEAMS = (N // 2 - 1, N // 2)


def _params(pkg):
    rp = (RuntimeParameters if pkg == "pyro2_tpu_torch" else JRP)()
    rp.load_params(f"{pkg}/_defaults")
    rp.load_params(f"{pkg}/solvers/compressible_rk/_defaults")
    problem = importlib.import_module(
        f"{pkg}.solvers.compressible_rk.problems.quad")
    for k, v in {**getattr(problem, "PROBLEM_PARAMS", {}),
                 "driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0,
                 **QUAD}.items():
        rp.set_param(k, v, no_new=False)
    return rp


def _interior(sim):
    g = sim.cc_data.grid
    return np.array(sim.cc_data.data[:, g.ilo:g.ihi + 1, g.jlo:g.jhi + 1])


def _seam_max(a):
    return max(np.abs(a[:, SEAMS, :]).max(), np.abs(a[:, :, SEAMS]).max())


@functools.lru_cache(maxsize=None)
def _serial(pkg):
    """(initial interior, the interior after one step at DT) of a package's
    serial rk solver."""
    mod = importlib.import_module(f"{pkg}.solvers.compressible_rk")
    pmod = importlib.import_module(
        f"{pkg}.solvers.compressible_rk.problems.quad")
    kw = {"device": "cpu"} if pkg == "pyro2_tpu_torch" else {}
    sim = mod.Simulation("compressible_rk", "quad", pmod.init_data,
                         _params(pkg), **kw)
    sim.initialize()
    U0 = _interior(sim)
    sim.cc_data.fill_BC_all()
    sim.dt = DT
    sim.evolve()
    return U0, _interior(sim)


def test_jax_sharded_rk_departs_at_the_seams():
    """The reference gap (ROADMAP.md section C.4): JAX's sharded rk is
    not its serial solver where the viscosity acts across a seam."""
    sh = JShardedRK(_params("pyro2_tpu"), jmake_mesh(shape=(2, 2)),
                    problem="quad")
    U0, ref = _serial("pyro2_tpu")
    got = np.asarray(sh.step(sh.init_interior(), 0.0, DT))
    scale = np.abs(ref).max()
    assert _seam_max(got - ref) > 1e-6 * scale


def test_port_sharded_rk_is_the_serial_step():
    """The port's 2x2 gloo run: the serial step's bits, JAX's serial step
    within 1e-12 of max|U|, and the viscosity the seams carry is real."""
    case = {"cls": "ShardedCompressibleRK", "problem": "quad",
            "params": _params("pyro2_tpu_torch").params, "steps": 1,
            "dt": DT}
    ranks = launch.run(trp.sharded_solvers, (2, 2), [case], device="cpu",
                       timeout=300)
    U0, U = _serial("pyro2_tpu_torch")
    for res in ranks:
        np.testing.assert_array_equal(res[0]["U0"], U0)
        np.testing.assert_array_equal(res[0]["U"], U)
    ref = _serial("pyro2_tpu")[1]
    assert np.abs(U - ref).max() <= 1e-12 * np.abs(ref).max()


def _serial_stage():
    """The port's serial quad frame after one step (filled) and its plain
    stage increment."""
    mod = importlib.import_module("pyro2_tpu_torch.solvers.compressible_rk")
    pmod = importlib.import_module(
        "pyro2_tpu_torch.solvers.compressible_rk.problems.quad")
    sim = mod.Simulation("compressible_rk", "quad", pmod.init_data,
                         _params("pyro2_tpu_torch"), device="cpu")
    sim.initialize()
    sim.cc_data.fill_BC_all()
    sim.dt = DT
    sim.evolve()
    sim.cc_data.fill_BC_all()
    U = sim.cc_data.data
    return sim, U, sim._step(U, sim.cc_data.t, DT)


@pytest.mark.parametrize("block", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_block_stage_needs_its_seam_flags(block):
    """Block `block` of a 2x2 split: its stage increment on the window of
    the serial filled frame equals the serial increment's window by bits.
    With the block's flags forced to 1 (every edge a domain edge), the
    plain stage departs from it on the cells next to a seam on the
    block's high side; block (1, 1), whose seams are on its low sides,
    keeps its bits (the low flags act on no face the stage computes)."""
    sim, U, k = _serial_stage()
    g = sim.cc_data.grid
    ng = g.ng
    ix, iy = block
    b = N // 2
    sh = ShardedCompressibleRK(_params("pyro2_tpu_torch"),
                               Mesh((2, 2), "cpu", block), problem="quad",
                               dtype=torch.float64)
    edges = sh.local_sim.domain_edges.flags()
    assert edges == (int(ix == 0), int(ix == 1), int(iy == 0), int(iy == 1))
    frame = U[:, ix * b:ix * b + b + 2 * ng,
              iy * b:iy * b + b + 2 * ng].contiguous()
    want = k[:, g.ilo + ix * b:g.ilo + (ix + 1) * b,
             g.jlo + iy * b:g.jlo + (iy + 1) * b]
    got = sh._block_step(frame, sim.cc_data.t, DT)[:, ng:-ng, ng:-ng]
    assert torch.equal(got, want)
    sh.local_sim.domain_edges = DomainEdges()
    forced = sh.local_sim._make_substep()(frame, sim.cc_data.t,
                                          DT)[:, ng:-ng, ng:-ng]
    if block == (1, 1):
        assert torch.equal(forced, want)
        return
    diff = (forced - want).abs()
    high = ([float(diff[:, b - 1].max())] if ix == 0 else []) + \
        ([float(diff[:, :, b - 1].max())] if iy == 0 else [])
    assert max(high) > 0.0
