"""The plain structure of the port's sharded multigrid (use_pallas=False,
comm_mode="sweep") through the half-sweep entry
(multigrid/sharded_mg_kernel.py `sweep`, csrc/mg_deep.cu k_sweep), and the
replicated coarse cycle from a level above the core kernel's
(mg_kernel.coarse_cycle), on the CPU in float64 (the plain versions).

* The half-sweep's plain version, composed as the plain structure runs it
  (a colour pass, then the seam exchange, each colour; then the residual
  and its restriction), equals the serial multigrid's `_smooth_n` (the
  `_smooth_once` colour passes with a ghost fill after each),
  `_residual` and `restrict_array` bit for bit: at every block of a 2x2
  and a 1x4 split (gloo ranks, tests/torch_rank_programs.py) and on a
  1x1 mesh, every sharded level down to 2x2 blocks, for the constant, vc
  and general operators on Dirichlet, Neumann, periodic and mixed edges.
  Only the corner ghosts, which no stencil reads, are left out.
* `coarse_cycle` from each level above CORE_MAX equals `_v_cycle` from
  that level bit for bit, for each operator, float64 and float32.
* `structure` (the plan a constructor takes, which allocates nothing)
  gives the JAX package's crossover and deep-halo geometry on its meshes.
"""

import numpy as np
import pytest
import torch

import torch_rank_programs as trp
from pyro2_tpu.parallel import make_mesh as jmake_mesh
from pyro2_tpu.parallel import sharded_mg as jsmg
from pyro2_tpu_torch.mesh.patch import restrict_array
from pyro2_tpu_torch.multigrid import mg_kernel
from pyro2_tpu_torch.multigrid import sharded_mg_kernel as smk
from pyro2_tpu_torch.parallel import launch, mesh_comm, sharded_mg

F64 = torch.float64
N = 16
N_ITER = 2
OPS = ("const", "vc", "general")
KINDS = {"dirichlet": ("dirichlet",) * 4, "neumann": ("neumann",) * 4,
         "periodic": ("periodic",) * 4,
         "mixed": ("dirichlet", "neumann", "periodic", "periodic")}
NEUMANN = ("neumann",) * 4


def _case(op, kinds, seed):
    """A rank program's case (torch_rank_programs.make_mg) of the plain
    sweep structure: the operator's coefficients smooth and positive."""
    g = np.arange(N + 2) - 0.5
    x = g[:, None] / N + 0 * g[None, :]
    y = 0 * g[:, None] + g[None, :] / N
    kw = dict(xl_BC_type=kinds[0], xr_BC_type=kinds[1], yl_BC_type=kinds[2],
              yr_BC_type=kinds[3], comm_mode="sweep", dtype=F64, nsmooth=3,
              nsmooth_bottom=4)
    case = {"op": op, "n": N, "seed": seed}
    if op == "const":
        case["kw"] = dict(kw, alpha=0.4, beta=-1.3)
    elif op == "vc":
        case["kw"] = kw
        case["eta"] = 2.0 + np.cos(2 * np.pi * x) * np.cos(2 * np.pi * y)
        case["coeffs_bc"] = NEUMANN
    else:
        case["kw"] = kw
        case["planes"] = {"alpha": 1.0 + x * y,
                          "beta": 2.0 + np.sin(np.pi * x) * y,
                          "gamma_x": np.sin(2 * np.pi * y),
                          "gamma_y": 0.5 * np.cos(2 * np.pi * x)}
        case["coeffs_bc"] = NEUMANN
    return case


CASES = [(op, kind) for op in OPS for kind in KINDS]


def _all_cases():
    return [_case(op, KINDS[kind], 11 + i)
            for i, (op, kind) in enumerate(CASES)]


def _serial_levels(case, levels):
    """The serial multigrid's n_iter iterations, residual and restriction
    at each level, from the rank program's global random v and f."""
    mg = trp.make_mg(mesh_comm.make_mesh(device="cpu"), case).serial
    rng = np.random.default_rng(case["seed"])
    out = {}
    for k in levels:
        g = mg.grids[k]
        v = torch.as_tensor(rng.standard_normal((g.qx, g.qy)))
        f = torch.as_tensor(rng.standard_normal((g.qx, g.qy)))
        vs = mg._smooth_n(k, v, f, N_ITER)
        r = mg._residual(k, vs, f)
        fc = restrict_array(r, g, mg.grids[k - 1]) if k > 0 else None
        out[k] = (vs, fc, r)
    return out


def _no_corners(a):
    """The frame with its four corner cells zeroed (no stencil reads
    them)."""
    a = a.clone()
    a[0, 0] = a[0, -1] = a[-1, 0] = a[-1, -1] = 0.0
    return a


def _check_rank(res, ref, px, py, ix, iy):
    for k, (vs, fc, r) in res.items():
        s_vs, s_fc, s_r = ref[k]
        bx, by = vs.shape[0] - 2, vs.shape[1] - 2
        w = (slice(ix * bx, ix * bx + bx + 2), slice(iy * by,
                                                     iy * by + by + 2))
        assert torch.equal(_no_corners(torch.as_tensor(vs)),
                           _no_corners(s_vs[w])), (k, ix, iy)
        # the residual frame: the owned block's, zero ghosts
        r = torch.as_tensor(r)
        assert torch.equal(r[1:-1, 1:-1], s_r[w][1:-1, 1:-1]), (k, ix, iy)
        assert not r[0].any() and not r[-1].any() and \
            not r[:, 0].any() and not r[:, -1].any()
        if fc is None:
            continue
        fc = torch.as_tensor(fc)
        cx, cy = bx // 2, by // 2
        assert torch.equal(fc[1:-1, 1:-1],
                           s_fc[1 + ix * cx:1 + (ix + 1) * cx,
                                1 + iy * cy:1 + (iy + 1) * cy]), (k, ix, iy)
        assert not fc[0].any() and not fc[-1].any() and \
            not fc[:, 0].any() and not fc[:, -1].any()


@pytest.fixture(scope="module", params=[(2, 2), (1, 4)],
                ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request):
    shape = request.param
    out = launch.run(trp.sweep_levels, shape, _all_cases(), N_ITER,
                     device="cpu", timeout=300)
    return shape, out


@pytest.mark.parametrize("op,kind", CASES)
def test_sweep_blocks_equal_the_serial_smoother(ranks, op, kind):
    shape, out = ranks
    px, py = shape
    i = CASES.index((op, kind))
    case = _all_cases()[i]
    levels = sorted(out[0][i])
    # every sharded level down to 2-cell blocks on the split axis
    assert min(2 ** (levels[0] + 1) // p for p in shape if p > 1) == 2
    ref = _serial_levels(case, levels)
    for rank, res in enumerate(out):
        _check_rank({k: tuple(None if a is None else torch.as_tensor(a)
                              for a in t) for k, t in res[i].items()},
                    ref, px, py, rank // py, rank % py)


@pytest.mark.parametrize("op,kind", CASES)
def test_sweep_one_block_equals_the_serial_smoother(op, kind):
    """On a 1x1 mesh every level is sharded, down to the 2x2 bottom, and
    each block is the whole level with its physical ghosts."""
    case = _all_cases()[CASES.index((op, kind))]
    mesh = mesh_comm.make_mesh(device="cpu")
    res = trp.sweep_levels(mesh, [case], N_ITER)[0]
    assert sorted(res) == list(range(N.bit_length() - 1))
    ref = _serial_levels(case, sorted(res))
    _check_rank(res, ref, 1, 1, 0, 0)
    for k, (vs, _, _) in res.items():           # the corners too
        assert torch.equal(vs, ref[k][0])


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_coarse_cycle_equals_v_cycle_above_core_max(op, dtype):
    """The replicated coarse cycle from each level above CORE_MAX (the
    serial kernels' peeled down / up levels and the core on the card)
    equals the serial _v_cycle from that level, from a zero guess."""
    n = 512
    mesh = mesh_comm.make_mesh(device="cpu")
    kinds = KINDS["mixed"]
    case = _case(op, kinds, 3)
    case["n"] = n
    if op == "vc":
        case["eta"] = np.ones((n + 2, n + 2)) * 1.5
    elif op == "general":
        case["planes"] = {c: np.full((n + 2, n + 2), val) for c, val in
                          (("alpha", 1.0), ("beta", 2.0),
                           ("gamma_x", 0.3), ("gamma_y", -0.2))}
    case["kw"] = dict(case["kw"], dtype=dtype, nsmooth=2,
                      nsmooth_bottom=10)
    serial = trp.make_mg(mesh, case).serial
    top = mg_kernel.split(serial, dtype)[0]
    assert 2 ** (top + 1) == mg_kernel.CORE_MAX[dtype]
    rng = np.random.default_rng(5)
    for kc in range(top + 1, serial.nlevels):
        g = serial.grids[kc]
        f = torch.zeros((g.qx, g.qy), dtype=dtype)
        f[1:-1, 1:-1] = torch.as_tensor(rng.standard_normal((g.nx, g.ny)))
        ref = serial._v_cycle(kc, torch.zeros_like(f), f)
        assert torch.equal(mg_kernel.coarse_cycle(serial, kc, f), ref), kc
    # at or below the core's top it is the core's cycle alone
    f = torch.zeros((2 ** (top + 1) + 2,) * 2, dtype=dtype)
    f[1:-1, 1:-1] = 1.0
    assert torch.equal(mg_kernel.coarse_cycle(serial, top, f),
                       serial._v_cycle(top, torch.zeros_like(f), f))


def test_structure_plans_the_replicated_level_above_core_max():
    """A 16x1 mesh of 256^2 float64 shards 256^2 alone (16-cell blocks
    along x): the replicated 128^2 level is above the float64 core's 64^2,
    so a cycle launches one core and a down and an up of the peeled
    level, and the sharded level two deep rounds each way (d 16 holds 7
    of its 10 sweeps) and a sweep for its residual and one for the
    top's."""
    st = sharded_mg.structure(256, 256, 16, 1, dtype=F64, op="vc",
                              use_pallas=False, cuda=True)
    assert st.k_cross == 7 and 2 ** st.k_cross > mg_kernel.CORE_MAX[F64]
    assert st.entries[6] == {"mg_core_vc": 1, "mg_down_vc": 1,
                             "mg_up_vc": 1}
    assert st.entries[7] == {"mg_deep_smooth": 4, "mg_sweep": 2,
                             "mg_correct": 1}
    # the constructor takes the same plan, and allocates no device memory
    mg = sharded_mg.ShardedVarCoeffMG(
        256, 256, mesh_comm.Mesh((16, 1), "cpu"), coeffs=np.ones((256, 256)),
        coeffs_bc=trp._bc(NEUMANN), use_pallas=False, dtype=F64)
    assert mg.k_cross == st.k_cross and mg.plan.entries == st.entries


MESHES = [(2, 2), (1, 4), (4, 1), (2, 4), (1, 8), (8, 1)]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("comm_mode,smoother",
                         [("deep", "rbgs"), ("deep", "jacobi"),
                          ("sweep", "rbgs")])
def test_structure_matches_jax(shape, comm_mode, smoother):
    """The plain structure's crossover and deep-halo geometry (d, the pad
    depths, the round schedules) are the JAX package's, on its fake
    devices."""
    px, py = shape
    n = 64
    jmg = jsmg.ShardedMG(n, n, jmake_mesh(shape=shape), comm_mode=comm_mode,
                         smoother=smoother)
    st = sharded_mg.structure(n, n, px, py, dtype=F64, comm_mode=comm_mode,
                              smoother=smoother, use_pallas=False,
                              cuda=False)
    assert st.k_cross == jmg.k_cross
    for k in range(st.k_cross, jmg.nlevels):
        want = jmg._deep_geom.get(k)
        got = st.deep_geom[k]
        if want is None:
            assert got is None, k
        else:
            assert {key: got[key] for key in want} == want, k


def test_sweep_entry_refuses_a_cuda_call_without_the_kernel():
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper's launch path checks it (and counts nothing); a call the
    kernel does not make is refused before either runs."""
    import pyro2_tpu_torch.mesh.boundary as bnd

    before = dict(smk.launches)
    bc = bnd.BC(xlb="neumann", xrb="neumann", ylb="neumann", yrb="neumann")
    meta = torch.empty((10, 10), dtype=F64, device="meta")
    kw = dict(dx=0.1, dy=0.1, bc=bc, px=1, py=1, ab=(0.0, -1.0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        smk.sweep(meta, meta, (0, 0, 0, 0, 1, 1, 1, 1), colour=0, **kw)
    cpu = torch.zeros((10, 10), dtype=F64)
    with pytest.raises(ValueError, match="after no colour pass"):
        smk.sweep(cpu, cpu, (0, 0, 0, 0, 1, 1, 1, 1), colour=1,
                  emit="v_fc", **kw)
    with pytest.raises(ValueError, match="colour"):
        smk.sweep(cpu, cpu, (0, 0, 0, 0, 1, 1, 1, 1), colour=2, **kw)
    assert smk.launches == before


def test_sweep_work_counts_one_colour():
    b, o = smk.work("mg_sweep", bx=8, by=8, dtype=F64, colour=0)
    assert b == 3 * 100 * 8 and o == 7 * 32
    b, o = smk.work("mg_sweep", bx=8, by=8, dtype=F64, emit="v_fc", ncoef=2)
    assert b == (5 * 100 + 36) * 8 and o == 12 * 64 + 4 * 16
