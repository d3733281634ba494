"""Parity of the PyTorch port's constant-coefficient multigrid with
pyro2_tpu.

The same inputs, made from a numpy seed, go through the JAX functions (CPU,
x64, tests/conftest.py) and their counterparts in pyro2_tpu_torch (CPU,
float64).  Tolerances:
  * transfers, views and the plain V-cycle against the jnp V-cycle: the
    same float64 operations in the same order, so 1e-13 max(1, max|x|)
    (XLA turns the smoother's division by the loop-invariant denominator
    into a product with its reciprocal, a rounding apart);
  * the plain kernel versions (core_plain, down_plain, up_plain) against
    the Pallas kernels in interpret mode: v to 1e-13 max(1, max|v|), the
    bound the JAX package's own fused-vs-jnp test uses (the Pallas kernels
    sum the four neighbours and transfer by matmuls, in another order).  A
    residual r = f - alpha v + beta L v cancels terms of size
    |beta| 8 max|v| / dx^2, so its roundoff is bounded relative to those
    terms: r to 1e-13 max(1, max|f| + |alpha| max|v| + 8 |beta| max|v|/dx^2);
  * a full solve against the jnp solve: equal cycle counts and the
    residual error to 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro2_tpu.mesh import patch as jpatch
from pyro2_tpu.mesh.grid import Grid2d as JGrid2d
from pyro2_tpu.mesh.indexer import ai as jai
from pyro2_tpu.multigrid import MG as JMG
from pyro2_tpu.multigrid import pallas_mg
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.multigrid import MG, mg_kernel

BC_SETS = {
    "dirichlet": ["dirichlet"] * 4,
    "periodic_x_neumann_y": ["periodic", "periodic", "neumann", "neumann"],
    "neumann": ["neumann"] * 4,
}
ALPHA, BETA = 0.7, -1.3


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(ref, got, tol=1e-13, scale=None):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    err = np.abs(ref - got).max()
    if scale is None:
        scale = np.abs(ref).max()
    assert err <= tol * max(1.0, scale), err


def _resid_scale(mg, level, v, f):
    """The size of the terms a residual of level `level` sums."""
    vmax, fmax = np.abs(_np(v)).max(), np.abs(_np(f)).max()
    return fmax + abs(mg.alpha) * vmax + \
        8.0 * abs(mg.beta) * vmax / mg.grids[level].dx ** 2


def _mg_pair(n, bcs, alpha=ALPHA, beta=BETA):
    kw = dict(xl_BC_type=bcs[0], xr_BC_type=bcs[1], yl_BC_type=bcs[2],
              yr_BC_type=bcs[3], alpha=alpha, beta=beta, verbose=0)
    return JMG.CellCenterMG2d(n, n, **kw), \
        MG.CellCenterMG2d(n, n, device="cpu", **kw)


def _frame(rng, q):
    return rng.standard_normal((q, q))


# -- mesh: views, transfers, clone --------------------------------------------

def test_strided_views_lap_and_norm_match_jax():
    rng = np.random.default_rng(0)
    jg, tg = JGrid2d(16, 12, ng=2), Grid2d(16, 12, ng=2)
    a = rng.standard_normal((tg.qx, tg.qy))
    ja, ta = jai(jnp.asarray(a), jg), ai(torch.as_tensor(a), tg)
    for s in (1, 2, 4):
        _close(ja.v(s=s), ta.v(s=s))
        _close(ja.ip(1, s=s), ta.ip(1, s=s))
        _close(ja.jp(-1, buf=1, s=s), ta.jp(-1, buf=1, s=s))
        _close(ja.ip_jp(1, 1, s=s), ta.ip_jp(1, 1, s=s))
    _close(ja.lap(), ta.lap())
    _close(ja.lap(buf=1), ta.lap(buf=1))
    assert abs(float(ja.norm()) - float(ta.norm())) <= \
        1e-14 * float(ja.norm())


@pytest.mark.parametrize("N", [2, 4])
def test_restrict_matches_jax(N):
    rng = np.random.default_rng(N)
    jf, tf = JGrid2d(16, 16, ng=1), Grid2d(16, 16, ng=1)
    a = rng.standard_normal((2, tf.qx, tf.qy))
    got = patch.restrict_array(torch.as_tensor(a), tf, tf.coarse_like(N), N)
    ref = jpatch.restrict_array(jnp.asarray(a), jf, jf.coarse_like(N), N)
    _close(ref, got)


def test_prolong_matches_jax():
    rng = np.random.default_rng(3)
    jc, tc = JGrid2d(8, 8, ng=1), Grid2d(8, 8, ng=1)
    a = rng.standard_normal((tc.qx, tc.qy))
    got = patch.prolong_array(torch.as_tensor(a), tc, tc.fine_like(2))
    ref = jpatch.prolong_array(jnp.asarray(a), jc, jc.fine_like(2))
    _close(ref, got)


def test_clone_copies_the_state():
    import pyro2_tpu_torch.mesh.boundary as bnd

    d = patch.CellCenterData2d(Grid2d(8, 8, ng=2), device="cpu")
    d.register_var("a", bnd.BC(xlb="periodic", xrb="periodic",
                               ylb="periodic", yrb="periodic"))
    d.create()
    d.set_var("a", np.arange(144.0).reshape(12, 12))
    d.t = 0.25
    c = patch.cell_center_data_clone(d)
    before = c.data.clone()
    d.data += 1.0                       # in-place writes to the original...
    d.fill_BC("a")
    assert torch.equal(c.data, before)  # ...leave the clone as it was
    assert c.t == 0.25 and c.names == d.names and c.BCs == d.BCs


# -- the plain kernel versions against the Pallas kernels (interpret) ---------

def _dx_of(tmg):
    return lambda level: tmg.soln_grid.dx * 2 ** (tmg.nlevels - 1 - level)


def _ab():
    return jnp.asarray([ALPHA, BETA])


@pytest.mark.parametrize("bc_set", list(BC_SETS))
def test_core_plain_matches_pallas_core(bc_set):
    bcs = BC_SETS[bc_set]
    _, tmg = _mg_pair(32, bcs)
    rng = np.random.default_rng(11)
    top = 2                                        # an 8^2 core
    q = 2 ** (top + 1) + 2
    v, f = _frame(rng, q), 10.0 * _frame(rng, q)
    kern = pallas_mg._make_core_kernel(top, _dx_of(tmg), tmg.nsmooth,
                                       tmg.nsmooth_bottom, tuple(bcs), True,
                                       jnp.float64, True)
    jv, jr = kern(_ab(), jnp.asarray(v), jnp.asarray(f))
    tv, tr = mg_kernel.core_plain(tmg, top, torch.as_tensor(v),
                                  torch.as_tensor(f), True)
    _close(jv, tv)
    _close(jr, tr, scale=_resid_scale(tmg, top, jv, f))


@pytest.mark.parametrize("bc_set", list(BC_SETS))
def test_down_plain_matches_pallas_down(bc_set):
    bcs = BC_SETS[bc_set]
    _, tmg = _mg_pair(32, bcs)
    rng = np.random.default_rng(12)
    level = tmg.nlevels - 1
    v, f = _frame(rng, 34), 10.0 * _frame(rng, 34)
    kern = pallas_mg._make_down_kernel(level, _dx_of(tmg), tmg.nsmooth,
                                       tuple(bcs), jnp.float64, True)
    jv, jfc = kern(_ab(), jnp.asarray(v), jnp.asarray(f))
    tv, tfc = mg_kernel.down_plain(tmg, level, torch.as_tensor(v),
                                   torch.as_tensor(f))
    _close(jv, tv)
    _close(jfc, tfc, scale=_resid_scale(tmg, level, jv, f))


@pytest.mark.parametrize("bc_set", list(BC_SETS))
def test_up_plain_matches_pallas_up(bc_set):
    bcs = BC_SETS[bc_set]
    _, tmg = _mg_pair(32, bcs)
    rng = np.random.default_rng(13)
    level = tmg.nlevels - 1
    v, f, vc = _frame(rng, 34), 10.0 * _frame(rng, 34), _frame(rng, 18)
    kern = pallas_mg._make_up_kernel(level, _dx_of(tmg), tmg.nsmooth,
                                     tuple(bcs), True, jnp.float64, True)
    jv, jr = kern(_ab(), jnp.asarray(v), jnp.asarray(f), jnp.asarray(vc))
    tv, tr = mg_kernel.up_plain(tmg, level, torch.as_tensor(v),
                                torch.as_tensor(f), torch.as_tensor(vc),
                                True)
    _close(jv, tv)
    _close(jr, tr, scale=_resid_scale(tmg, level, jv, f))


@pytest.mark.parametrize("bc_set", list(BC_SETS))
def test_peeled_cycle_matches_fused_pallas_cycle(bc_set, monkeypatch):
    """downs -> core -> ups with two peeled levels on both sides."""
    bcs = BC_SETS[bc_set]
    monkeypatch.setattr(pallas_mg, "CORE_MAX", 8)
    monkeypatch.setitem(mg_kernel.CORE_MAX, torch.float64, 8)
    jmg, tmg = _mg_pair(32, bcs)
    assert mg_kernel.split(tmg, torch.float64) == (2, [3, 4])
    g = tmg.soln_grid
    f = np.sin(2 * np.pi * g.x2d) * np.cos(4 * np.pi * g.y2d) + 0.3 * g.x2d
    fused = pallas_mg.build_fused_cycle(jmg, interpret=True)
    jv, jr, _ = fused(jnp.zeros(f.shape), jnp.asarray(f), jmg._params())
    tv, tr = mg_kernel.cycle(tmg, torch.zeros(f.shape, dtype=torch.float64),
                             torch.as_tensor(f))
    _close(jv, tv)
    _close(jr, tr, scale=_resid_scale(tmg, tmg.nlevels - 1, jv, f))


# -- the V-cycle and the solve against the jnp path ---------------------------

# the operators of the solvers: incompressible's Poisson projection on a
# periodic domain, and diffusion's Crank-Nicolson Helmholtz operator
# (beta = dt k / 2 with dt = 2 dx^2) on Neumann walls
OPERATORS = {
    "poisson_periodic": (["periodic"] * 4, 0.0, -1.0),
    "helmholtz_neumann": (["neumann"] * 4, 1.0, None),
}


@pytest.mark.parametrize("op", list(OPERATORS))
@pytest.mark.parametrize("n", [32, 64])
def test_v_cycle_matches_jnp(n, op):
    bcs, alpha, beta = OPERATORS[op]
    jmg, tmg = _mg_pair(n, bcs, alpha=alpha,
                        beta=(1.0 / n) ** 2 if beta is None else beta)
    rng = np.random.default_rng(n)
    q = n + 2
    v, f = 0.1 * _frame(rng, q), _frame(rng, q)
    nlev = jmg.nlevels - 1
    jv = jmg._v_cycle(nlev, jnp.asarray(v), jnp.asarray(f), jmg._params())
    jr = jmg._residual(nlev, jv, jnp.asarray(f), jmg._params())
    tv, tr = mg_kernel.cycle(tmg, torch.as_tensor(v), torch.as_tensor(f))
    _close(jv, tv)
    _close(jr, tr, scale=_resid_scale(tmg, nlev, jv, f))


def _poisson(g):
    f = -2.0 * ((1.0 - 6.0 * g.x2d ** 2) * g.y2d ** 2 * (1.0 - g.y2d ** 2) +
                (1.0 - 6.0 * g.y2d ** 2) * g.x2d ** 2 * (1.0 - g.x2d ** 2))
    true = (g.x2d ** 2 - g.x2d ** 4) * (g.y2d ** 4 - g.y2d ** 2)
    return f, true


@pytest.mark.parametrize("n", [32, 64])
def test_solve_matches_jnp(n):
    jmg, tmg = _mg_pair(n, BC_SETS["dirichlet"], alpha=0.0, beta=-1.0)
    f, true = _poisson(tmg.soln_grid)
    jmg.init_zeros()
    jmg.init_RHS(jnp.asarray(f))
    jmg.solve(rtol=1e-11)
    tmg.init_zeros()
    tmg.init_RHS(f)
    tmg.solve(rtol=1e-11)
    assert tmg.num_cycles == jmg.num_cycles
    assert abs(tmg.residual_error - jmg.residual_error) <= \
        1e-12 * jmg.residual_error
    assert tmg.residual_error < 1e-11
    _close(jmg.get_solution(), tmg.get_solution())
    g = tmg.soln_grid
    err = float(ai(tmg.get_solution() - torch.as_tensor(true), g).norm())
    # the truncation error of this problem is 1.02e-4 at 32^2 and 2.57e-5 at
    # 64^2 (the JAX package's multigrid tests)
    assert err < {32: 1.1e-4, 64: 3.0e-5}[n], err


def test_warm_start_solution_gradient_and_object_match_jax():
    bcs = ["periodic"] * 4
    jmg, tmg = _mg_pair(32, bcs, alpha=0.0, beta=-1.0)
    g = tmg.soln_grid
    f = -8 * np.pi ** 2 * np.sin(2 * np.pi * g.x2d) * np.sin(2 * np.pi * g.y2d)
    guess = 0.01 * np.cos(2 * np.pi * g.x2d)
    for m, arr in ((jmg, jnp.asarray), (tmg, torch.as_tensor)):
        m.init_solution(arr(guess))
        m.init_RHS(arr(f))
        m.solve(rtol=1e-10)
    assert tmg.num_cycles == jmg.num_cycles
    og_j, og_t = JGrid2d(32, 32, ng=4), Grid2d(32, 32, ng=4)
    # the copy onto a 4-ghost grid carries the first ghost ring (corners too)
    _close(jmg.get_solution(grid=og_j), tmg.get_solution(grid=og_t))
    for a, b in zip(jmg.get_solution_gradient(grid=og_j),
                    tmg.get_solution_gradient(grid=og_t)):
        _close(a, b)
    jd, td = jmg.get_solution_object(), tmg.get_solution_object()
    _close(jd.data, td.data)


def test_solve_does_not_write_its_inputs():
    _, tmg = _mg_pair(16, BC_SETS["neumann"], alpha=1.0, beta=1e-3)
    rng = np.random.default_rng(4)
    guess = torch.as_tensor(_frame(rng, 18))
    rhs = torch.as_tensor(_frame(rng, 18))
    g0, f0 = guess.clone(), rhs.clone()
    tmg.init_solution(guess)
    tmg.init_RHS(rhs)
    tmg.solve(rtol=1e-10)
    assert torch.equal(guess, g0) and torch.equal(rhs, f0)
    assert not torch.equal(tmg.get_solution(), g0)


def test_cached_levels_and_masks_survive_in_place_writes():
    """The level grids and colour masks are cached by configuration and
    shared by every MG in the process.  Writing in place into what the
    caches hand out must change no later solve: the masks come out as
    copies, and the grids' coordinate arrays refuse writes."""
    bcs = ["periodic"] * 4

    def solve():
        _, tmg = _mg_pair(32, bcs, alpha=0.0, beta=-1.0)
        f, _ = _poisson(tmg.soln_grid)
        tmg.init_zeros()
        tmg.init_RHS(f - f.mean())
        tmg.solve(rtol=1e-10)
        return tmg, tmg.get_solution().clone()

    tmg, ref = solve()
    for g in tmg.grids:
        red, black = MG._color_masks(g, torch.device("cpu"))
        red.fill_(False)
        black.fill_(False)
        with pytest.raises(ValueError, match="read-only"):
            g.x[:] = 0.0
        with pytest.raises(ValueError, match="read-only"):
            g.y2d[0, 0] = 1.0
    _, got = solve()
    assert torch.equal(got, ref)


def test_solve_counts_cycles():
    _, tmg = _mg_pair(16, BC_SETS["neumann"], alpha=1.0, beta=1e-3)
    before = dict(MG.stats)
    tmg.init_zeros()
    tmg.init_RHS(np.ones((18, 18)))
    tmg.solve(rtol=1e-10)
    assert MG.stats["solves"] == before["solves"] + 1
    assert MG.stats["cycles"] == before["cycles"] + tmg.num_cycles > 0


# -- the kernel wrapper -------------------------------------------------------

def test_cpu_tensors_run_the_plain_versions():
    _, tmg = _mg_pair(16, BC_SETS["dirichlet"])
    before = dict(mg_kernel.launches)
    rng = np.random.default_rng(5)
    v, f = torch.as_tensor(_frame(rng, 18)), torch.as_tensor(_frame(rng, 18))
    got = mg_kernel.cycle(tmg, v, f)
    ref = mg_kernel.core_plain(tmg, tmg.nlevels - 1, v, f, True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert mg_kernel.launches == before
    for launch, args in ((mg_kernel.launch_core, (3, v, f, True)),
                         (mg_kernel.launch_down, (3, v, f)),
                         (mg_kernel.launch_up, (3, v, f, f[:10, :10], True))):
        with pytest.raises(ValueError, match="CUDA"):
            launch(tmg, *args)
    assert mg_kernel.launches == before


def test_split_follows_the_shared_memory_limit():
    _, m1024 = _mg_pair(1024, BC_SETS["neumann"])
    assert mg_kernel.split(m1024, torch.float32) == (6, [7, 8, 9])
    assert mg_kernel.split(m1024, torch.float64) == (5, [6, 7, 8, 9])
    _, m64 = _mg_pair(64, BC_SETS["neumann"])
    assert mg_kernel.split(m64, torch.float32) == (5, [])


@pytest.mark.parametrize("case,match", [
    ("extended_bc", "A.26"),
    ("subclass", "A.10"),
])
def test_uncovered_configurations_raise(case, match, monkeypatch):
    import pyro2_tpu_torch.mesh.boundary as bnd

    kw = dict(xl_BC_type="dirichlet", xr_BC_type="dirichlet",
              yl_BC_type="dirichlet", yr_BC_type="dirichlet", device="cpu")
    if case == "extended_bc":
        monkeypatch.setitem(bnd.bc_solid, "lid", True)
        monkeypatch.setitem(bnd.ext_bcs, "lid", lambda *a: a[-1])
        kw["yr_BC_type"] = "lid"
        mg = MG.CellCenterMG2d(16, 16, **kw)
    else:
        class Sub(MG.CellCenterMG2d):
            pass
        mg = Sub(16, 16, **kw)
    with pytest.raises(NotImplementedError, match=match):
        mg_kernel.check(mg)
    assert issubclass(mg_kernel.Ineligible, NotImplementedError)


@pytest.mark.parametrize("op", ["const", "vc", "general"])
def test_check_accepts_bc_values(op):
    """Inhomogeneous values on the finest level: the kernels take them
    through the lifted right-hand side (mg_kernel.lifted_rhs), under every
    operator, and the coarse levels stay homogeneous."""
    import pyro2_tpu_torch.mesh.boundary as bnd
    from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d
    from pyro2_tpu_torch.multigrid.variable_coeff_MG import VarCoeffCCMG2d

    kw = dict(xl_BC_type="neumann", xr_BC_type="dirichlet",
              yl_BC_type="dirichlet", yr_BC_type="neumann", device="cpu")
    values = dict(xl_BC=lambda y: 1.0 + 0 * y, yr_BC=lambda x: x)
    if op == "const":
        mg = MG.CellCenterMG2d(16, 16, **values, **kw)
    elif op == "vc":
        mg = VarCoeffCCMG2d(16, 16, coeffs=np.ones((18, 18)),
                            coeffs_bc=bnd.BC(), **kw)
        mg.bc_v[-1] = bnd.BC(xlb="neumann", xrb="dirichlet",
                             ylb="dirichlet", yrb="neumann",
                             xl_func=values["xl_BC"],
                             yr_func=values["yr_BC"], grid=mg.grids[-1])
    else:
        d = patch.CellCenterData2d(Grid2d(16, 16, ng=1), device="cpu")
        for name in ("alpha", "beta", "gamma_x", "gamma_y"):
            d.register_var(name, bnd.BC())
        d.create()
        d.set_var("beta", np.ones((18, 18)))
        mg = GeneralMG2d(16, 16, coeffs=d, **values, **kw)
    assert mg_kernel.has_values(mg.bc_v[-1])
    assert not any(mg_kernel.has_values(b) for b in mg.bc_v[:-1])
    assert mg_kernel.check(mg) == op
    assert mg_kernel.edge_kinds(mg.bc_v[-1]) == [0, 1, 1, 0]


def test_check_accepts_every_standard_kind():
    for kinds in (["outflow", "neumann", "reflect-even", "reflect-odd"],
                  ["periodic", "periodic", "dirichlet", "dirichlet"]):
        mg = MG.CellCenterMG2d(16, 16, xl_BC_type=kinds[0],
                               xr_BC_type=kinds[1], yl_BC_type=kinds[2],
                               yr_BC_type=kinds[3], device="cpu")
        mg_kernel.check(mg)


def test_work_counts_frames_and_operations():
    n, ns = 1024, 10
    b, ops = mg_kernel.work("mg_down", n, ns, torch.float32)
    assert b == (3 * 1026 ** 2 + 514 ** 2) * 4
    assert ops == (7 * ns + 13) * n * n + 4 * 512 ** 2
    b, _ = mg_kernel.work("mg_up", n, ns, torch.float64, want_r=False)
    assert b == (3 * 1026 ** 2 + 514 ** 2) * 8
    b, ops = mg_kernel.work("mg_core", 2, ns, torch.float32,
                            with_guess=False, want_r=False)
    assert b == 2 * 16 * 4 and ops == 7 * 50 * 4
    with pytest.raises(ValueError):
        mg_kernel.work("mg_side", n, ns, torch.float32)


def test_mg_needs_a_device_or_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MG.CellCenterMG2d(16, 16)
    m = MG.CellCenterMG2d(16, 16, device="cpu")
    assert m.v[-1].dtype == torch.float64
