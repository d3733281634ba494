"""Parity of the PyTorch port's sharded multigrid (pyro2_tpu_torch/parallel/
sharded_mg.py and multigrid/sharded_mg_kernel.py) with pyro2_tpu's.

The port's ranks run under parallel.launch on gloo (CPU, float64) and never
import JAX (tests/torch_rank_programs.py); this process computes the JAX
side on conftest's 8 fake CPU devices, on the same mesh shape.  On the CPU
both structures of the port run: the kernel structure on the kernels'
plain versions, and the plain (jnp-shaped) one.  Tolerances, float64:

  * deep_smooth_plain and correct_plain against the JAX package's Pallas
    kernels in interpret mode inside shard_map, at every block position of
    a 2x2 and a 1x4 mesh: the frame to 1e-13 max(1, max|v|); a residual to
    1e-13 of the terms it cancels, |f| + |alpha| |v| + 8 |beta| |v| / dx^2
    (for the coefficient forms 8 max|edge coefficient| |v|, plus alpha and
    the gamma differences): the Pallas kernel sums the Laplacian's
    neighbours in another order and restricts by matmuls;
  * solves of every operator and smoother on 2x2 and 1x4 meshes against
    the JAX package's on the same mesh shape: equal cycle counts and the
    solution to 1e-12 max(1, max|v|) (the norms are sums over every block
    taken in other orders, and XLA divides by a loop-invariant denominator
    as a product with its reciprocal);
  * the deep schedule against the exchange-per-half-sweep one, and a 1x1
    mesh against the serial CellCenterMG2d: bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import pyro2_tpu.mesh.boundary as jbnd
import torch_rank_programs as trp
from pyro2_tpu.mesh import patch as jpatch
from pyro2_tpu.mesh.grid import Grid2d as JGrid2d
from pyro2_tpu.multigrid.pallas_sharded_mg import (build_correct_kernel,
                                                   build_deep_smooth_kernel)
from pyro2_tpu.parallel import make_mesh as jmake_mesh
from pyro2_tpu.parallel import sharded_mg as jsmg
import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.multigrid import mg_kernel
from pyro2_tpu_torch.multigrid import sharded_mg_kernel as smk
from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d
from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d
from pyro2_tpu_torch.multigrid.variable_coeff_MG import VarCoeffCCMG2d
from pyro2_tpu_torch.parallel import launch, mesh_comm, sharded_mg

F64 = torch.float64
SHAPES = [(2, 2), (1, 4)]
SMOOTHERS = ("rbgs", "jacobi", "chebyshev")
OPS = ("const", "vc", "general")
N = 32
CONST_KW = dict(xl_BC_type="dirichlet", xr_BC_type="neumann",
                yl_BC_type="periodic", yr_BC_type="periodic", alpha=0.3,
                beta=-1.2)
NEUMANN = ("neumann",) * 4


def _grid():
    return JGrid2d(N, N, ng=1)


def _const_rhs():
    x = (np.arange(N) + 0.5) / N
    X, Y = np.meshgrid(x, x, indexing="ij")
    return np.sin(2 * np.pi * X) * np.sin(2 * np.pi * Y) + \
        0.3 * np.cos(3 * np.pi * X * Y)


def _vc_problem():
    """tests/test_parallel.py TestShardedVarCoeffMG's eta and f."""
    g = _grid()
    eta = 2.0 + np.cos(2 * np.pi * g.x2d) * np.cos(2 * np.pi * g.y2d)
    f = (-16.0 * np.pi ** 2 *
         (np.cos(2 * np.pi * g.x2d) * np.cos(2 * np.pi * g.y2d) + 1) *
         np.sin(2 * np.pi * g.x2d) * np.sin(2 * np.pi * g.y2d))
    return eta, f


def _general_problem():
    """tests/test_parallel.py TestShardedGeneralMG's coefficients and f."""
    g = _grid()
    planes = {"alpha": np.ones((g.qx, g.qy)),
              "beta": 2.0 + np.cos(2 * np.pi * g.x2d) *
              np.cos(2 * np.pi * g.y2d),
              "gamma_x": np.sin(2 * np.pi * g.x2d),
              "gamma_y": np.sin(2 * np.pi * g.y2d)}
    f = ((-16.0 * np.pi ** 2 * np.cos(2 * np.pi * g.x2d) *
          np.cos(2 * np.pi * g.y2d) +
          2.0 * np.pi * np.cos(2 * np.pi * g.x2d) +
          2.0 * np.pi * np.cos(2 * np.pi * g.y2d) -
          16.0 * np.pi ** 2 + 1.0) *
         np.sin(2 * np.pi * g.x2d) * np.sin(2 * np.pi * g.y2d))
    return planes, f


def _case(op, **kw):
    """A rank program's case (torch_rank_programs.make_mg)."""
    if op == "const":
        return {"op": op, "n": N, "kw": dict(CONST_KW, dtype=F64, **kw),
                "f": _const_rhs()}
    if op == "vc":
        eta, f = _vc_problem()
        return {"op": op, "n": N, "kw": dict(dtype=F64, **kw), "eta": eta,
                "coeffs_bc": NEUMANN, "f": f}
    planes, f = _general_problem()
    return {"op": op, "n": N, "kw": dict(dtype=F64, **kw),
            "planes": planes, "coeffs_bc": NEUMANN, "f": f}


@functools.lru_cache(maxsize=None)
def _jax_solve(shape, op, smoother):
    """The JAX package's sharded solve of a case on a mesh of `shape`:
    (cycles, solution, source norm, residual error)."""
    mesh = jmake_mesh(shape=shape)
    bc = jbnd.BC(xlb="neumann", xrb="neumann", ylb="neumann", yrb="neumann")
    if op == "const":
        mg = jsmg.ShardedMG(N, N, mesh, smoother=smoother, **CONST_KW)
        f = _const_rhs()
    elif op == "vc":
        eta, f = _vc_problem()
        mg = jsmg.ShardedVarCoeffMG(N, N, mesh, coeffs=jnp.asarray(eta),
                                    coeffs_bc=bc, smoother=smoother)
    else:
        planes, f = _general_problem()
        d = jpatch.CellCenterData2d(_grid())
        for name in planes:
            d.register_var(name, bc)
        d.create()
        for name, a in planes.items():
            d.set_var(name, jnp.asarray(a))
        mg = jsmg.ShardedGeneralMG(N, N, mesh, coeffs=d, smoother=smoother)
    mg.init_zeros()
    mg.init_RHS(jnp.asarray(f))
    mg.solve(rtol=1e-11)
    return (mg.num_cycles, np.asarray(mg.get_solution()), mg.source_norm,
            mg.residual_error, mg.k_cross)


# the port solves every operator with every smoother in the plain structure,
# and in the kernel structure with red-black Gauss-Seidel (and the constant
# operator's speed smoothers), on each mesh
SOLVES = [(op, sm, False) for op in OPS for sm in SMOOTHERS] + \
    [(op, "rbgs", True) for op in OPS] + \
    [("const", sm, True) for sm in ("jacobi", "chebyshev")]
# the JAX package's solves they are held against: every operator with
# red-black Gauss-Seidel on both meshes, and each speed smoother of each
# operator on one of them (a JAX solve costs seconds of compilation)
SPEED = {(2, 2): {"const": "jacobi", "vc": "chebyshev", "general": "jacobi"},
         (1, 4): {"const": "chebyshev", "vc": "jacobi",
                  "general": "chebyshev"}}


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def ranks(request):
    """(mesh shape, {case: each rank's result}) of one launch: SOLVES, the
    sweep schedule of the constant and vc operators, and the ghosts of an
    empty deep round."""
    shape = request.param
    cases = [_case(op, smoother=sm, use_pallas=up) for op, sm, up in SOLVES]
    cases += [_case(op, comm_mode="sweep") for op in ("const", "vc")]
    empty = _case("const", smoother="jacobi", nsmooth_speed=0,
                  use_pallas=False)
    jobs = [("mg_solves", (cases,)),
            ("deep_ghosts", (empty, N.bit_length() - 2)),
            ("gradient", (_case("const"), _gradient_field()))]
    out = launch.run(trp.several, shape, jobs, device="cpu", timeout=300)
    solves = {}
    for i, key in enumerate(SOLVES + [("const", "sweep"), ("vc", "sweep")]):
        solves[key] = [res[0][i] for res in out]
    solves["gradient"] = [res[2] for res in out]
    return shape, solves, [res[1] for res in out]


def _gradient_field():
    return np.random.default_rng(12).standard_normal((N, N))


def _close(ref, got, tol, scale=None):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    err = np.abs(ref - got).max()
    if scale is None:
        scale = np.abs(ref).max()
    assert err <= tol * max(1.0, scale), err


# -- solves against the JAX package -------------------------------------------

@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("kind", ["rbgs", "speed"])
def test_solve_matches_jax(ranks, kind, op):
    shape, solves, _ = ranks
    smoother = "rbgs" if kind == "rbgs" else SPEED[shape][op]
    cycles, v_ref, _, _, k_cross = _jax_solve(shape, op, smoother)
    px, py = shape
    bx, by = N // px, N // py
    for use_pallas in (False, True):
        per_rank = solves.get((op, smoother, use_pallas))
        if per_rank is None:
            continue
        for r, res in enumerate(per_rank):
            ix, iy = r // py, r % py
            np.testing.assert_array_equal(
                res["block"], per_rank[0]["gathered"][
                    ix * bx:(ix + 1) * bx, iy * by:(iy + 1) * by])
        if use_pallas and smoother != "rbgs":
            # the kernel structure replicates more levels, which the serial
            # core smooths by red-black Gauss-Seidel: another algorithm,
            # converged to the same solution
            assert abs(per_rank[0]["cycles"] - cycles) <= 2
            assert per_rank[0]["residual_error"] <= 1e-11
            _close(v_ref, per_rank[0]["gathered"], 1e-9)
            continue
        assert [res["cycles"] for res in per_rank] == [cycles] * px * py
        _close(v_ref, per_rank[0]["gathered"], 1e-12)
        # the plain structure replicates what the JAX package replicates
        if not use_pallas:
            assert per_rank[0]["k_cross"] == k_cross


@pytest.mark.parametrize("key", [("const", "rbgs", False),
                                 ("vc", "rbgs", True)])
def test_norms_are_global(ranks, key):
    # every rank reports the whole domain's norms: a rank's own sum would
    # differ from block to block and from the JAX package's
    shape, solves, _ = ranks
    _, _, source_norm, residual_error, _ = _jax_solve(shape, key[0], key[1])
    for res in solves[key]:
        assert abs(res["source_norm"] - source_norm) <= 1e-14 * source_norm
        # the residual at convergence is roundoff of both solutions: equal
        # to a factor well inside the 1/2 a block's own sum would give
        assert abs(res["residual_error"] - residual_error) <= \
            0.25 * residual_error
        for k in ("residual_error", "relative_error"):
            assert res[k] == solves[key][0][k]


def test_solution_gradient_matches_jax(ranks):
    shape, solves, _ = ranks
    mg = jsmg.ShardedMG(N, N, jmake_mesh(shape=shape), **CONST_KW)
    mg.init_solution(jnp.asarray(_gradient_field()))
    ref = [np.asarray(g) for g in mg.get_solution_gradient_interior()]
    px, py = shape
    bx, by = N // px, N // py
    for r, (gx, gy) in enumerate(solves["gradient"]):
        ix, iy = r // py, r % py
        w = (slice(ix * bx, (ix + 1) * bx), slice(iy * by, (iy + 1) * by))
        np.testing.assert_array_equal(gx, ref[0][w])
        np.testing.assert_array_equal(gy, ref[1][w])


@pytest.mark.parametrize("op", ["const", "vc"])
def test_deep_equals_sweep_bitwise(ranks, op):
    _, solves, _ = ranks
    deep, sweep = solves[(op, "rbgs", False)], solves[(op, "sweep")]
    for d, s in zip(deep, sweep):
        assert d["cycles"] == s["cycles"]
        np.testing.assert_array_equal(d["block"], s["block"])


def test_empty_deep_round_leaves_valid_ghosts(ranks):
    # nsmooth_speed = 0: no step, but the one-ghost block comes back with
    # the ghosts the halo exchange gives
    _, _, ghosts = ranks
    for res in ghosts:
        assert res["sweeps"] == []
        np.testing.assert_array_equal(res["deep"], res["halo"])


# -- the plain versions against the JAX package's kernels ---------------------

TWIN_BCS = {(2, 2): ("dirichlet", "neumann", "periodic", "periodic"),
            (1, 4): ("periodic", "periodic", "dirichlet", "neumann")}
BX, D, DX = 8, 5, 1.0 / 16
AB = (0.7, -1.3)


def _twin_inputs(shape, ncoef):
    """Global (px Fx, py Fy) frames of v and f, and the (ncoef, ...) plane
    stack, from a seed."""
    px, py = shape
    dpx, dpy = (D if px > 1 else 1), (D if py > 1 else 1)
    bx, by = (BX, BX) if shape == (2, 2) else (2 * BX, BX)
    Fx, Fy = bx + 2 * dpx, by + 2 * dpy
    rng = np.random.default_rng(5 + ncoef)
    vd = 0.1 * rng.standard_normal((px * Fx, py * Fy))
    fd = rng.standard_normal((px * Fx, py * Fy))
    planes = None
    if ncoef == 2:
        planes = 256.0 * rng.uniform(1.0, 3.0, (2, px * Fx, py * Fy))
    elif ncoef == 5:
        planes = 256.0 * rng.uniform(1.0, 3.0, (5, px * Fx, py * Fy))
        planes[0] *= -1.0
        planes[3:] = 8.0 * rng.uniform(-1.0, 1.0, (2, px * Fx, py * Fy))
    return dict(bx=bx, by=by, dpx=dpx, dpy=dpy, Fx=Fx, Fy=Fy), vd, fd, \
        planes


def _resid_scale(v, f, planes):
    vmax, fmax = np.abs(v).max(), np.abs(f).max()
    if planes is None:
        return fmax + abs(AB[0]) * vmax + 8.0 * abs(AB[1]) * vmax / DX ** 2
    top = [np.abs(p).max() for p in planes]
    if len(top) == 2:
        return fmax + 8.0 * max(top) * vmax
    return fmax + (top[0] + 8.0 * max(top[1:3]) + 2.0 * sum(top[3:])) * vmax


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("smoother", SMOOTHERS)
@pytest.mark.parametrize("ncoef", [0, 2, 5])
def test_deep_smooth_plain_matches_pallas(shape, smoother, ncoef):
    px, py = shape
    geo, vd, fd, planes = _twin_inputs(shape, ncoef)
    kinds = TWIN_BCS[shape]
    jbc = jbnd.BC(xlb=kinds[0], xrb=kinds[1], ylb=kinds[2], yrb=kinds[3])
    n_sweeps = (D - 1) // 2 if smoother == "rbgs" else D - 1
    kernels = [build_deep_smooth_kernel(
        bx=geo["bx"], by=geo["by"], dpx=geo["dpx"], dpy=geo["dpy"], d=D,
        n_sweeps=n_sweeps, dx=DX, dy=DX, bc=jbc, px=px, py=py, emit=emit,
        smoother=smoother, ncoef=ncoef, dtype=jnp.float64, interpret=True)
        for emit in smk.EMITS]
    flags_of = jsmg.ShardedMG.__new__(jsmg.ShardedMG)
    flags_of.px, flags_of.py, flags_of.bc = px, py, jbc

    def body(v, f, *c):
        flags = jsmg.ShardedMG._kernel_flags(flags_of)
        outs = []
        for k in kernels:
            if ncoef == 0:
                outs += list(k(flags, jnp.asarray(AB), v, f))
            else:
                outs += list(k(flags, v, f, c[0]))
        return tuple(outs)

    args = [jnp.asarray(vd), jnp.asarray(fd)]
    specs = [P("x", "y"), P("x", "y")]
    if ncoef:
        args.append(jnp.asarray(planes))
        specs.append(P(None, "x", "y"))
    fn = jax.jit(jax.shard_map(body, mesh=jmake_mesh(shape=shape),
                               in_specs=tuple(specs),
                               out_specs=(P("x", "y"),) * 5,
                               check_vma=False))
    outs = [np.asarray(o) for o in fn(*args)]
    # kernels' outputs in order: v (v); v, fc (v_fc); v, r (v_r)
    bc = bnd.BC(xlb=kinds[0], xrb=kinds[1], ylb=kinds[2],
                      yrb=kinds[3])
    Fx, Fy = geo["Fx"], geo["Fy"]
    qcx, qcy = geo["bx"] // 2 + 2, geo["by"] // 2 + 2
    for ix in range(px):
        for iy in range(py):
            win = (slice(ix * Fx, (ix + 1) * Fx),
                   slice(iy * Fy, (iy + 1) * Fy))
            cwin = (slice(ix * qcx, (ix + 1) * qcx),
                    slice(iy * qcy, (iy + 1) * qcy))
            kw = dict(dpx=geo["dpx"], dpy=geo["dpy"], d=D, n_sweeps=n_sweeps,
                      dx=DX, dy=DX, bc=bc, px=px, py=py, smoother=smoother)
            c_blk = None
            if ncoef:
                c_blk = planes[(slice(None),) + win]
                kw["planes"] = torch.as_tensor(c_blk)
            else:
                kw["ab"] = AB
            flags = sharded_mg.kernel_flags(bc, px, py, ix, iy)
            v_blk, f_blk = torch.as_tensor(vd[win]), torch.as_tensor(fd[win])
            for e, emit in enumerate(smk.EMITS):
                v, extra = smk.deep_smooth_plain(v_blk, f_blk, flags,
                                                 emit=emit, **kw)
                ref_v = outs[[0, 1, 3][e]][win]
                _close(ref_v, v, 1e-13)
                if emit == "v":
                    assert extra is None
                    continue
                ref_x = outs[[0, 2, 4][e]][cwin if emit == "v_fc" else win]
                _close(ref_x, extra, 1e-13,
                       _resid_scale(ref_v, fd[win], c_blk))
                if emit == "v_r":          # zero outside the interior
                    outside = extra.clone()
                    outside[geo["dpx"]:geo["dpx"] + geo["bx"],
                            geo["dpy"]:geo["dpy"] + geo["by"]] = 0.0
                    assert not outside.any()
                else:                      # the coarse frame's ghosts zero
                    assert not extra[0].any() and not extra[-1].any()
                    assert not extra[:, 0].any() and not extra[:, -1].any()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_correct_plain_matches_pallas(shape):
    px, py = shape
    bx, by = N // px, N // py
    rng = np.random.default_rng(9)
    v = rng.standard_normal((px * (bx + 2), py * (by + 2)))
    vc = rng.standard_normal((px * (bx // 2 + 2), py * (by // 2 + 2)))
    k = build_correct_kernel(bx=bx, by=by, dtype=jnp.float64, interpret=True)
    fn = jax.jit(jax.shard_map(lambda a, b: k(a, b)[0],
                               mesh=jmake_mesh(shape=shape),
                               in_specs=(P("x", "y"), P("x", "y")),
                               out_specs=P("x", "y"), check_vma=False))
    ref = np.asarray(fn(jnp.asarray(v), jnp.asarray(vc)))
    for ix in range(px):
        for iy in range(py):
            w = (slice(ix * (bx + 2), (ix + 1) * (bx + 2)),
                 slice(iy * (by + 2), (iy + 1) * (by + 2)))
            wc = (slice(ix * (bx // 2 + 2), (ix + 1) * (bx // 2 + 2)),
                  slice(iy * (by // 2 + 2), (iy + 1) * (by // 2 + 2)))
            got = smk.correct_plain(torch.as_tensor(v[w]),
                                    torch.as_tensor(vc[wc]))
            _close(ref[w], got, 1e-13)
            # the ghosts are the input's
            np.testing.assert_array_equal(got[0], v[w][0])
            np.testing.assert_array_equal(got[:, -1], v[w][:, -1])


# -- one block, and the set-up, in this process -------------------------------

def _serial(op):
    if op == "const":
        return CellCenterMG2d(N, N, device="cpu", **CONST_KW), _const_rhs()
    bc = bnd.BC(xlb="neumann", xrb="neumann", ylb="neumann",
                      yrb="neumann")
    if op == "vc":
        eta, f = _vc_problem()
        return VarCoeffCCMG2d(N, N, coeffs=eta, coeffs_bc=bc,
                              device="cpu"), f
    planes, f = _general_problem()
    return GeneralMG2d(N, N, coeffs=trp._general_coeffs(
        Grid2d(N, N, ng=1), planes, NEUMANN), device="cpu"), f


@pytest.mark.parametrize("op", OPS)
def test_one_block_equals_the_serial_solver(op):
    mesh = mesh_comm.make_mesh(device="cpu")
    ser, f = _serial(op)
    f_int = f if f.shape == (N, N) else f[1:-1, 1:-1]
    fp = np.zeros((N + 2, N + 2))
    fp[1:-1, 1:-1] = f_int
    ser.init_zeros()
    ser.init_RHS(fp)
    ser.solve(rtol=1e-11)
    ref = ser.get_solution()[1:-1, 1:-1]
    for use_pallas in (False, True):
        mg = trp.make_mg(mesh, _case(op, use_pallas=use_pallas))
        mg.init_zeros()
        mg.init_RHS(f)
        mg.solve(rtol=1e-11)
        assert mg.num_cycles == ser.num_cycles
        assert mg.source_norm == pytest.approx(ser.source_norm, rel=1e-15)
        assert torch.equal(mg.get_solution(), ref)
        assert torch.equal(mg.gather_solution(), ref)


def test_kernel_structure_crossover_and_launches(monkeypatch):
    # the core kernel holds up to CORE_MAX[dtype] on one block (64^2 when
    # blocks exchange): 512^2 float32 shards 256^2 and 512^2 above a 128^2
    # core, float64 one level more; a cycle calls 2 deep rounds and 1
    # correction per sharded level and 1 core
    one = mesh_comm.make_mesh(device="cpu")
    for dtype, shards in ((torch.float32, 2), (F64, 3)):
        mg = sharded_mg.make_sharded_mg(512, 512, one, dtype=dtype)
        assert mg.nlevels - mg.k_cross == shards
        assert mg.serial.grids[mg.k_cross - 1].nx == mg_kernel.CORE_MAX[dtype]
    four = mesh_comm.Mesh((2, 2), "cpu")        # set-up needs no collective
    mg = sharded_mg.make_sharded_mg(512, 512, four, dtype=torch.float32)
    assert mg.serial.grids[mg.k_cross - 1].nx == 64
    calls = {"deep": 0, "correct": 0, "core": 0}

    def counted(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(smk, "deep_smooth", counted("deep", smk.deep_smooth))
    monkeypatch.setattr(smk, "correct", counted("correct", smk.correct))
    monkeypatch.setattr(mg_kernel, "core", counted("core", mg_kernel.core))
    mg = sharded_mg.make_sharded_mg(512, 512, one, dtype=torch.float32,
                                    xl_BC_type="neumann",
                                    xr_BC_type="neumann", alpha=1.0,
                                    beta=(1.0 / 512) ** 2)
    f = torch.as_tensor(np.random.default_rng(2).standard_normal((514, 514)),
                        dtype=torch.float32)
    v, r = mg._cycle_local(torch.zeros_like(f), f)
    assert calls == {"deep": 2 * 2, "correct": 2, "core": 1}
    assert r.shape == (512, 512) and bool(torch.isfinite(v).all())


@pytest.mark.parametrize("use_pallas,comm_mode",
                         [(False, "deep"), (True, "deep"), (None, "sweep")])
def test_alpha_beta_are_read_at_every_solve(use_pallas, comm_mode):
    # ShardedDiffusion sets them every step: no cached copy may go stale
    mesh = mesh_comm.make_mesh(device="cpu")
    f = _const_rhs()
    kw = dict(CONST_KW, use_pallas=use_pallas, comm_mode=comm_mode)
    mg = sharded_mg.ShardedMG(N, N, mesh, **kw)
    mg.init_RHS(f)
    mg.solve(rtol=1e-11)
    mg.serial.alpha, mg.serial.beta = 1.0, -0.05
    mg.init_zeros()
    mg.solve(rtol=1e-11)
    fresh = sharded_mg.ShardedMG(N, N, mesh, **dict(kw, alpha=1.0,
                                                    beta=-0.05))
    fresh.init_RHS(f)
    fresh.solve(rtol=1e-11)
    assert mg.num_cycles == fresh.num_cycles
    assert torch.equal(mg.get_solution(), fresh.get_solution())


def test_plain_structure_refused_on_cuda():
    """Nothing of the plain structure is refused on a CUDA mesh but what the
    half-sweep kernel cannot cover.  `structure` (which allocates nothing)
    gives each level's kernel entries on a 1x1 CUDA mesh at 1024^2 float32:
    with use_pallas=False every level of 4^2 and up runs mg_deep_smooth
    rounds, one mg_sweep for its residual and one mg_correct, the 2x2
    bottom 100 mg_sweep colour passes and the top one more for its
    residual; with comm_mode="sweep" each level's smoothing is 4 x 10
    mg_sweep passes.  Neither launches a plain version's entry or the
    serial kernels (no replicated level).  A block of odd sides is refused
    naming A.31."""
    for op in OPS:
        for kw in ({"use_pallas": False}, {"comm_mode": "sweep"}):
            st = sharded_mg.structure(1024, 1024, 1, 1,
                                      dtype=torch.float32, op=op, cuda=True,
                                      **kw)
            assert not st.use_pallas and st.k_cross == 0
            assert sorted(st.entries) == list(range(10))
            assert st.entries[0] == {"mg_sweep": 100}
            for k in range(1, 10):
                want = ({"mg_deep_smooth": 2, "mg_sweep": 1}
                        if "use_pallas" in kw else {"mg_sweep": 41})
                want["mg_correct"] = 1
                if k == 9:
                    want["mg_sweep"] += 1
                assert st.entries[k] == want, (op, kw, k)
            assert set(st.launches) <= set(smk.launches)
    # the kernel structure is the one use_pallas=None picks on CUDA
    st = sharded_mg.structure(1024, 1024, 1, 1, dtype=torch.float32,
                              cuda=True)
    assert st.use_pallas and st.k_cross == 7
    assert st.launches == {"mg_deep_smooth": 6, "mg_correct": 3,
                           "mg_core": 1}
    bc = bnd.BC(xlb="neumann", xrb="neumann", ylb="neumann", yrb="neumann")
    odd = torch.empty((7, 6), dtype=torch.float32, device="meta")
    for fn in (smk.sweep, smk.sweep_plain):
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.31"):
            fn(odd, odd, (0, 0, 0, 0, 1, 1, 1, 1), colour=0, dx=0.1, dy=0.1,
               bc=bc, px=1, py=1, ab=AB)


def test_make_sharded_mg_builds_the_kernel_structure_without_fallback(
        monkeypatch):
    mesh = mesh_comm.make_mesh(device="cpu")
    assert sharded_mg.make_sharded_mg(N, N, mesh).use_pallas
    assert not sharded_mg.ShardedMG(N, N, mesh).use_pallas   # CPU default

    def fail(*a, **kw):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(sharded_mg.ShardedMG, "_setup_mesh", fail)
    with pytest.raises(RuntimeError, match="kernel failed"):
        sharded_mg.make_sharded_mg(N, N, mesh)


def test_unsupported_bc_and_non_cpu_tensors_raise():
    mesh = mesh_comm.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        sharded_mg.ShardedMG(N, N, mesh, xl_BC_type="hse")
    # a tensor that is not on the CPU never takes the plain version
    before = dict(smk.launches)
    meta = torch.empty((12, 12), dtype=F64, device="meta")
    bc = bnd.BC(xlb="neumann", xrb="neumann", ylb="neumann",
                      yrb="neumann")
    with pytest.raises(ValueError, match="CUDA tensors"):
        smk.deep_smooth(meta, meta, (0, 0, 0, 0, 1, 1, 1, 1), dpx=1, dpy=1,
                        d=3, n_sweeps=1, dx=0.1, dy=0.1, bc=bc, px=1, py=1,
                        ab=AB)
    with pytest.raises(ValueError, match="CUDA tensors"):
        smk.correct(meta, torch.empty((7, 7), dtype=F64, device="meta"))
    assert smk.launches == before


def test_work_counts_the_updates_the_flags_allow():
    b, o = smk.work("mg_deep_smooth", bx=8, by=8, dtype=F64, d=21,
                    n_sweeps=10, emit="v_fc")
    # one block, one halo cell: every sweep updates the 64 interior cells
    assert o == 7 * 64 * 10 + 13 * 64 + 4 * 16
    assert b == 8 * (3 * 100 + 36)
    # a seam on x-lo: the halo band takes updates too, shrinking per step
    _, o2 = smk.work("mg_deep_smooth", bx=8, by=8, dtype=F64, dpx=5, d=5,
                     n_sweeps=4, flags=(1, 0, 0, 0, 0, 1, 1, 1),
                     smoother="jacobi")
    assert o2 == (7 + 3) * 8 * (12 + 11 + 10 + 9)
    assert smk.work("mg_correct", bx=8, by=8, dtype=torch.float32) == \
        (4 * (2 * 100 + 36), 9 * 64)
