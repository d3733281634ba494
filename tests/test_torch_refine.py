"""Double-f32 iterative refinement (pyro2_tpu_torch/multigrid/refine.py)
against pyro2_tpu/multigrid/refine.py, on the CPU.

* two_sum and two_prod in float32 equal exact float64 arithmetic by bits
  (the JAX package's test; not by bits against JAX's jitted version, whose
  compiler may contract a product and a sum);
* solve_ir in float32 at 128^2 meets the bounds of the JAX package's
  TestIterativeRefinement: the direct solve stalls above 1e-6, the refined
  residual is below 1e-4 of it and below 3e-9, and hi + lo lies within
  1e-8 of a float64 solve and of JAX's solve_ir on the same float32 input;
* solve_ir_sharded on a 2 x 2 gloo mesh at 128^2 meets the bounds of the
  JAX package's TestShardedIterativeRefinement;
* the refusals raise ValueError, as JAX's do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu.multigrid import MG as JMG
from pyro2_tpu.multigrid.refine import solve_ir as jsolve_ir
from pyro2_tpu_torch.multigrid import MG, refine
from pyro2_tpu_torch.multigrid.variable_coeff_MG import VarCoeffCCMG2d
from pyro2_tpu_torch.parallel import launch, make_mesh
from pyro2_tpu_torch.parallel.sharded_mg import ShardedMG

import torch_rank_programs as trp

N = 128


def _rhs(g):
    x, y = g.x2d, g.y2d
    return -2.0 * ((1.0 - 6.0 * x ** 2) * y ** 2 * (1.0 - y ** 2) +
                   (1.0 - 6.0 * y ** 2) * x ** 2 * (1.0 - x ** 2))


def _f64_solution(f32):
    mg64 = MG.CellCenterMG2d(N, N, device="cpu", dtype=torch.float64)
    mg64.init_zeros()
    mg64.init_RHS(torch.as_tensor(f32, dtype=torch.float64))
    mg64.solve(rtol=1e-11)
    g = mg64.soln_grid
    return mg64.get_solution()[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1].numpy()


@pytest.mark.parametrize("seed,scale", [(7, 1e-6), (8, 1.0), (9, 1e6)])
def test_two_sum_two_prod_exact(seed, scale):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=4096).astype(np.float32)
    b = (rng.normal(size=4096) * scale).astype(np.float32)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)

    s, e = refine.two_sum(ta, tb)
    assert s.dtype == e.dtype == torch.float32
    exact = a.astype(np.float64) + b.astype(np.float64)
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(),
                                  exact)
    # s is the rounded sum, e what rounding lost
    np.testing.assert_array_equal(s.numpy(), a + b)

    p, pe = refine.two_prod(ta, tb)
    # the float64 product of two float32 values is exact (24 + 24 < 53)
    exactp = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(p.double().numpy() + pe.double().numpy(),
                                  exactp)

    hi, lo = refine._split(ta)
    np.testing.assert_array_equal(hi.numpy() + lo.numpy(), a)
    # hi keeps at most 12 significant bits
    m, _ = np.frexp(hi.numpy().astype(np.float64))
    np.testing.assert_array_equal(m * 2 ** 12, np.round(m * 2 ** 12))


def test_solve_ir_f32_deep_tolerance_matches_jax():
    mg = MG.CellCenterMG2d(N, N, device="cpu", dtype=torch.float32)
    g = mg.soln_grid
    f32 = _rhs(g).astype(np.float32)
    mg.init_zeros()
    mg.init_RHS(f32)
    mg.solve(rtol=1e-10)
    res_direct = mg.residual_error
    assert res_direct > 1e-6      # the float32 stall

    mg.init_zeros()
    mg.init_RHS(f32)
    f_before = mg.f[-1]
    norm_before = mg.source_norm
    res, n_ref = refine.solve_ir(mg, rtol=1e-10)
    assert res < 1e-4 * res_direct, (res, res_direct)
    assert res < 3e-9, res
    assert (mg.residual_error, mg.num_cycles) == (res, n_ref)
    assert mg.f[-1] is f_before and mg.source_norm == norm_before
    assert mg.v[-1].dtype == mg.v_lo.dtype == torch.float32

    interior = (slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
    v = mg.get_solution().double() + mg.v_lo.double()
    assert np.abs(v[interior].numpy() - _f64_solution(f32)).max() < 1e-8
    # v[-1]'s ghosts are filled (homogeneous Dirichlet: odd reflections)
    hi = mg.get_solution()
    assert torch.equal(hi[0, 1:-1], -hi[1, 1:-1])

    # JAX's solve_ir on the same float32 input
    jmg = JMG.CellCenterMG2d(N, N, verbose=0)
    jmg.v = [a.astype(jnp.float32) for a in jmg.v]
    jmg.f = [a.astype(jnp.float32) for a in jmg.f]
    jmg.init_zeros()
    jmg.init_RHS(jnp.asarray(f32))
    jres, jn = jsolve_ir(jmg, rtol=1e-10)
    assert jres < 3e-9
    jv = np.asarray(jmg.get_solution(), np.float64) + \
        np.asarray(jmg.v_lo, np.float64)
    assert np.abs(v.numpy() - jv)[interior].max() < 1e-8


def test_solve_ir_refusals():
    kw = dict(device="cpu", dtype=torch.float32)
    mg = MG.CellCenterMG2d(16, 16, **kw)
    with pytest.raises(ValueError, match="RHS"):
        refine.solve_ir(mg)

    vc = VarCoeffCCMG2d(16, 16, coeffs=np.ones((18, 18)),
                        coeffs_bc=bnd.BC(), **kw)
    vc.init_RHS(np.zeros((18, 18)))
    with pytest.raises(ValueError, match="constant"):
        refine.solve_ir(vc)

    values = MG.CellCenterMG2d(16, 16, xl_BC=lambda y: 1.0 + 0 * y, **kw)
    values.init_RHS(np.zeros((18, 18)))
    with pytest.raises(ValueError, match="homogeneous"):
        refine.solve_ir(values)

    ext = MG.CellCenterMG2d(16, 16, **kw)
    ext.bc_v = ext.bc_v[:-1] + [bnd.BC(yrb="reflect")]
    ext.bc_v[-1].yrb = "lid"
    ext.init_RHS(np.zeros((18, 18)))
    with pytest.raises(ValueError, match="standard"):
        refine.solve_ir(ext)

    smg = ShardedMG(16, 16, make_mesh(device="cpu"), dtype=torch.float32)
    with pytest.raises(ValueError, match="RHS"):
        refine.solve_ir_sharded(smg)
    with pytest.raises(ValueError, match="ShardedMG"):
        refine.solve_ir_sharded(values)


def test_solve_ir_sharded_2x2_f32_deep_tolerance():
    mg = MG.CellCenterMG2d(N, N, device="cpu")
    g = mg.soln_grid
    f32 = _rhs(g).astype(np.float32)
    out = launch.run(trp.refined_solve, (2, 2), N, f32, device="cpu",
                     timeout=300)
    for rank in out:
        assert rank["direct"] > 1e-6      # the float32 stall
        assert rank["refined"] < 1e-4 * rank["direct"]
        assert rank["refined"] < 3e-9
        assert rank["hi"].dtype == rank["lo"].dtype == np.float32
    assert len({(r["refined"], r["passes"], r["source_norm"])
                for r in out}) == 1
    # the blocks of rank r = 2 ix + iy, against a serial float64 solve
    b = N // 2
    v = np.zeros((N, N))
    for r, rank in enumerate(out):
        ix, iy = divmod(r, 2)
        blk = (slice(ix * b, (ix + 1) * b), slice(iy * b, (iy + 1) * b))
        v[blk] = rank["hi"].astype(np.float64) + rank["lo"]
        # f_int is restored
        np.testing.assert_array_equal(
            rank["f"], f32[1:-1, 1:-1][blk])
    assert np.abs(v - _f64_solution(f32)).max() < 1e-8
