"""Parity of the PyTorch port's coefficient multigrid (EdgeCoeffs,
VarCoeffCCMG2d, GeneralMG2d and the plain versions of their kernels) with
pyro2_tpu.

The same inputs, made from a numpy seed, go through the JAX functions (CPU,
x64, tests/conftest.py) and their counterparts in pyro2_tpu_torch (CPU,
float64).  Tolerances:
  * edge coefficients, the coefficient hierarchy, each level's smoother and
    residual: the same float64 operations in the same order, so
    1e-13 max(1, max|x|);
  * one V-cycle against the jnp cycle, and the plain kernel versions
    (core_plain, down_plain, up_plain, and the cycle they make) against
    the JAX package's Pallas kernels in interpret mode
    (pallas_gen_mg._make_*_kernel_g and build_fused_cycle_general): v to
    1e-13 max(1, max|v|), the bound the JAX package's own fused-vs-jnp
    tests use (XLA may turn the smoother's division by its loop-invariant
    denominator into a product with the reciprocal, a rounding apart).  A
    residual f - L v cancels terms of the size of 8 max|edge coefficient|
    max|v| (plus alpha and the gamma differences for the general
    operator), so it is held to 1e-13 of that;
  * a full solve against the jnp solve: equal cycle counts, the solution
    to 1e-13 max(1, max|v|), and the residual error (relative to the
    source norm) to 1e-12 absolute: at convergence it is itself roundoff
    (~4e-13), so it agrees only to the size of that roundoff.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro2_tpu.mesh.boundary as jbnd
import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu.mesh import patch as jpatch
from pyro2_tpu.mesh.grid import Grid2d as JGrid2d
from pyro2_tpu.multigrid import MG as JMG
from pyro2_tpu.multigrid import pallas_gen_mg, pallas_mg
from pyro2_tpu.multigrid.edge_coeffs import EdgeCoeffs as JEdgeCoeffs
from pyro2_tpu.multigrid.general_MG import GeneralMG2d as JGeneral
from pyro2_tpu.multigrid.variable_coeff_MG import VarCoeffCCMG2d as JVC
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.multigrid import MG, mg_kernel
from pyro2_tpu_torch.multigrid.edge_coeffs import EdgeCoeffs
from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d
from pyro2_tpu_torch.multigrid.variable_coeff_MG import VarCoeffCCMG2d

# the solution edges: Dirichlet walls, Neumann walls, and lm_atm's phi
# (periodic x, Neumann bottom, Dirichlet top)
EDGES = {
    "dirichlet": ("dirichlet",) * 4,
    "neumann": ("neumann",) * 4,
    "lm_atm": ("periodic", "periodic", "neumann", "dirichlet"),
}
# the coefficient's own ghost fills: lm_atm passes the density's
# (periodic x, reflect bottom, outflow top); the others Neumann
COEFF_BC = {
    "dirichlet": ("neumann",) * 4,
    "neumann": ("neumann",) * 4,
    "lm_atm": ("periodic", "periodic", "reflect", "outflow"),
}


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(ref, got, tol=1e-13, scale=None):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    err = np.abs(ref - got).max()
    if scale is None:
        scale = np.abs(ref).max()
    assert err <= tol * max(1.0, scale), err


def _bc_pair(kinds):
    kw = dict(xlb=kinds[0], xrb=kinds[1], ylb=kinds[2], yrb=kinds[3])
    return jbnd.BC(**kw), bnd.BC(**kw)


def _eta(g):
    """A positive, stratified coefficient with a bump, as beta0^2 / rho."""
    x, y = g.x2d, g.y2d
    return np.exp(-2.0 * y) * (1.0 + 0.5 * np.exp(
        -((x - 0.4) ** 2 + (y - 0.6) ** 2) / 0.02)) + \
        0.1 * np.cos(2 * np.pi * x)


def _vc_pair(n, edges, ng_coeff=1, nsmooth=10):
    """A JAX and a port VarCoeffCCMG2d from the same coefficient frame,
    built on a grid with `ng_coeff` ghosts (the solvers pass ng=4)."""
    g = Grid2d(n, n, ng=ng_coeff)
    c = _eta(g)
    jbc, tbc = _bc_pair(COEFF_BC[edges])
    e = EDGES[edges]
    kw = dict(xl_BC_type=e[0], xr_BC_type=e[1], yl_BC_type=e[2],
              yr_BC_type=e[3], nsmooth=nsmooth, verbose=0)
    return (JVC(n, n, coeffs=jnp.asarray(c), coeffs_bc=jbc, **kw),
            VarCoeffCCMG2d(n, n, coeffs=c, coeffs_bc=tbc, device="cpu",
                           **kw))


def _general_pair(n, edges="dirichlet", ng_coeff=1):
    """The operator of tests/test_multigrid.py's TestGeneralMG (alpha 10,
    beta = xy + 1, gamma = (1, 1)) with a small varying gamma added."""
    jg, tg = JGrid2d(n, n, ng=ng_coeff), Grid2d(n, n, ng=ng_coeff)
    vals = {"alpha": np.full((tg.qx, tg.qy), 10.0),
            "beta": tg.x2d * tg.y2d + 1.0,
            "gamma_x": 1.0 + 0.2 * np.sin(2 * np.pi * tg.y2d),
            "gamma_y": np.ones((tg.qx, tg.qy))}
    jbc, tbc = _bc_pair(("neumann",) * 4)
    jd = jpatch.CellCenterData2d(jg)
    td = patch.CellCenterData2d(tg, device="cpu")
    for name in vals:
        jd.register_var(name, jbc)
        td.register_var(name, tbc)
    jd.create()
    td.create()
    for name, a in vals.items():
        jd.set_var(name, jnp.asarray(a))
        td.set_var(name, a)
    e = EDGES[edges]
    kw = dict(xl_BC_type=e[0], xr_BC_type=e[1], yl_BC_type=e[2],
              yr_BC_type=e[3], verbose=0)
    return JGeneral(n, n, coeffs=jd, **kw), \
        GeneralMG2d(n, n, coeffs=td, device="cpu", **kw)


def _pair(kind, n, edges):
    return _vc_pair(n, edges) if kind == "vc" else _general_pair(n, edges)


CASES = [("vc", "dirichlet"), ("vc", "neumann"), ("vc", "lm_atm"),
         ("general", "dirichlet"), ("general", "lm_atm")]


def _resid_scale(tmg, level, v, f):
    """The size of the terms a residual of `level` sums (see the module
    docstring)."""
    vmax, fmax = np.abs(_np(v)).max(), np.abs(_np(f)).max()
    top = tmg.planes[level].abs().amax(dim=(1, 2)).tolist()
    if len(top) == 2:
        return fmax + 8.0 * max(top) * vmax
    alpha, bx, by, gx, gy = top
    return fmax + (alpha + 8.0 * max(bx, by) + 2.0 * (gx + gy)) * vmax


def _frame(rng, q, scale=1.0):
    return scale * rng.standard_normal((q, q))


# -- edge coefficients and the coefficient hierarchy --------------------------

@pytest.mark.parametrize("n", [8, 16])
def test_edge_coeffs_and_restrict_match_jax(n):
    rng = np.random.default_rng(n)
    jg, tg = JGrid2d(n, n, ng=1), Grid2d(n, n, ng=1)
    eta = 1.0 + rng.random((tg.qx, tg.qy))
    je, te = JEdgeCoeffs(jg, jnp.asarray(eta)), EdgeCoeffs(tg, torch.as_tensor(
        eta))
    _close(je.x, te.x)
    _close(je.y, te.y)
    # the window (0, 1): lo..hi+1 on both axes, zero elsewhere
    assert not te.x[:tg.ilo].any() and not te.x[:, tg.jhi + 2:].any()
    for _ in range(2):
        je, te = je.restrict(), te.restrict()
        _close(je.x, te.x)
        _close(je.y, te.y)
    assert te.grid.nx == n // 4


@pytest.mark.parametrize("edges", list(EDGES))
def test_vc_hierarchy_from_a_four_ghost_frame_matches_jax(edges):
    jmg, tmg = _vc_pair(16, edges, ng_coeff=4)
    assert len(tmg.aux["coeffs"]) == len(tmg.edge_coeffs) == tmg.nlevels
    for lv in range(tmg.nlevels):
        _close(jmg.aux["coeffs"][lv], tmg.aux["coeffs"][lv])
        _close(jmg.edge_coeffs[lv].x, tmg.edge_coeffs[lv].x)
        _close(jmg.edge_coeffs[lv].y, tmg.edge_coeffs[lv].y)
        # the kernels' plane stack is the hierarchy itself
        assert torch.equal(tmg.planes[lv][0], tmg.edge_coeffs[lv].x)
    assert tmg.aux_bc["coeffs"] == bnd.BC(
        **dict(zip(("xlb", "xrb", "ylb", "yrb"), COEFF_BC[edges])))


def test_vc_rejects_a_coefficient_of_another_size():
    with pytest.raises(IndexError, match="not the same size"):
        VarCoeffCCMG2d(16, 16, coeffs=np.ones((20, 21)),
                       coeffs_bc=bnd.BC(), device="cpu")


def test_general_hierarchy_from_a_four_ghost_grid_matches_jax():
    jmg, tmg = _general_pair(16, ng_coeff=4)
    for lv in range(tmg.nlevels):
        for name in ("alpha", "beta", "gamma_x", "gamma_y"):
            _close(jmg.aux[name][lv], tmg.aux[name][lv])
        _close(jmg.beta_edge[lv].x, tmg.beta_edge[lv].x)
        _close(jmg.beta_edge[lv].y, tmg.beta_edge[lv].y)
        g = tmg.grids[lv]
        # the gammas of the plane stack are pre-scaled by 0.5/dx, 0.5/dy
        _close(0.5 * jmg.aux["gamma_x"][lv] / g.dx, tmg.planes[lv][3])
        _close(0.5 * jmg.aux["gamma_y"][lv] / g.dy, tmg.planes[lv][4])


# -- each level's smoother and residual ---------------------------------------

@pytest.mark.parametrize("kind,edges", CASES)
def test_each_level_smoother_and_residual_match_jax(kind, edges):
    jmg, tmg = _pair(kind, 16, edges)
    params = jmg._params()
    rng = np.random.default_rng(7)
    for lv in range(tmg.nlevels):
        q = tmg.grids[lv].qx
        v, f = _frame(rng, q, 0.1), _frame(rng, q)
        jv = jmg._smooth_once(lv, jmg._fill_v(lv, jnp.asarray(v)),
                              jnp.asarray(f), params)
        tv = tmg._smooth_once(lv, tmg._fill_v(lv, torch.as_tensor(v)),
                              torch.as_tensor(f))
        _close(jv, tv)
        jr = jmg._residual(lv, jnp.asarray(v), jnp.asarray(f), params)
        tr = tmg._residual(lv, torch.as_tensor(v), torch.as_tensor(f))
        _close(jr, tr, scale=_resid_scale(tmg, lv, v, f))


def test_smoother_solves_each_cell_it_updates():
    """A Gauss-Seidel half-sweep solves the equation of every cell it
    updates, given its neighbours: after a red-black iteration the black
    cells' residuals vanish (away from the edges, where a cell also reads
    its own mirror ghost, refilled only after the sweep).  The vc update
    is (-f + sum eta v) / sum eta, a positive denominator: a sign slip
    leaves them standing."""
    for kind in ("vc", "general"):
        _, tmg = _pair(kind, 16, "lm_atm")
        lv = tmg.nlevels - 1
        g = tmg.grids[lv]
        rng = np.random.default_rng(3)
        v = torch.as_tensor(_frame(rng, 18, 0.1))
        f = torch.as_tensor(_frame(rng, 18))
        v1 = tmg._smooth_once(lv, tmg._fill_v(lv, v.clone()), f)
        r = tmg._residual(lv, v1, f)
        inner = torch.zeros((g.qx, g.qy), dtype=torch.bool)
        inner[g.ilo + 1:g.ihi, g.jlo + 1:g.jhi] = True
        black = MG._color_masks(g, r.device)[1] & inner    # a new tensor
        scale = _resid_scale(tmg, lv, v1, f)
        assert r[black].abs().max() <= 1e-13 * scale
        assert r[~black].abs().max() > 1e-3 * scale


# -- one cycle and the solve against the jnp path -----------------------------

@pytest.mark.parametrize("kind,edges", CASES)
def test_v_cycle_matches_jnp(kind, edges):
    jmg, tmg = _pair(kind, 32, edges)
    rng = np.random.default_rng(5)
    q = 34
    v, f = _frame(rng, q, 0.1), _frame(rng, q)
    nlev = jmg.nlevels - 1
    params = jmg._params()
    jv = jmg._v_cycle(nlev, jnp.asarray(v), jnp.asarray(f), params)
    jr = jmg._residual(nlev, jv, jnp.asarray(f), params)
    tv, tr = mg_kernel.cycle(tmg, torch.as_tensor(v), torch.as_tensor(f))
    _close(jv, tv)
    _close(jr, tr, scale=_resid_scale(tmg, nlev, jv, f))


def _vc_rhs(g):
    """TestVarCoeff's problem: eta = 2 + cos cos, phi = sin sin."""
    x, y = g.x2d, g.y2d
    return (-16.0 * np.pi ** 2 *
            (np.cos(2 * np.pi * x) * np.cos(2 * np.pi * y) + 1) *
            np.sin(2 * np.pi * x) * np.sin(2 * np.pi * y))


@pytest.mark.parametrize("kind,edges", [("vc", "dirichlet"),
                                        ("vc", "lm_atm"),
                                        ("general", "dirichlet")])
def test_solve_matches_jnp_with_equal_cycles(kind, edges):
    jmg, tmg = _pair(kind, 32, edges)
    g = tmg.soln_grid
    f = _vc_rhs(g)
    for m, arr in ((jmg, jnp.asarray), (tmg, torch.as_tensor)):
        m.init_zeros()
        m.init_RHS(arr(f))
        m.solve(rtol=1e-11)
    assert tmg.num_cycles == jmg.num_cycles > 1
    _close(jmg.get_solution(), tmg.get_solution())
    assert abs(tmg.residual_error - jmg.residual_error) <= 1e-12
    assert tmg.residual_error < 1e-11


def test_vc_solve_converges_to_the_exact_solution():
    """TestVarCoeff's problem through the port: the 2nd-order truncation
    error at 32^2 is ~1e-2 (tests/test_multigrid.py)."""
    n = 32
    g = Grid2d(n, n, ng=1)
    eta = 2.0 + np.cos(2.0 * np.pi * g.x2d) * np.cos(2.0 * np.pi * g.y2d)
    mg = VarCoeffCCMG2d(n, n, coeffs=eta, coeffs_bc=bnd.BC(
        xlb="neumann", xrb="neumann", ylb="neumann", yrb="neumann"),
        device="cpu")
    mg.init_zeros()
    mg.init_RHS(_vc_rhs(g))
    mg.solve(rtol=1e-11)
    true = np.sin(2.0 * np.pi * g.x2d) * np.sin(2.0 * np.pi * g.y2d)
    err = float(ai(mg.get_solution() - torch.as_tensor(true), g).norm())
    assert err < 2.5e-2 and mg.residual_error < 1e-11


# -- the plain kernel versions against the Pallas kernels (interpret) ---------

def _stacks(jmg):
    _, prep = pallas_gen_mg._plane_prep(jmg)
    return prep(jmg._params())


@pytest.mark.parametrize("kind,edges", CASES)
def test_plain_entries_match_pallas_kernels(kind, edges):
    """core_plain, down_plain and up_plain of a 32^2 operator against
    _make_core_kernel_g (8^2 top), _make_down_kernel_g and
    _make_up_kernel_g of the finest level."""
    jmg, tmg = _pair(kind, 32, edges)
    ncoef = 2 if kind == "vc" else 5
    bcs = pallas_mg._bc_kinds(jmg)
    Cs = _stacks(jmg)
    rng = np.random.default_rng(11)
    top, fine = 2, tmg.nlevels - 1

    q = 2 ** (top + 1) + 2
    v, f = _frame(rng, q, 0.1), _frame(rng, q)
    kern = pallas_gen_mg._make_core_kernel_g(
        top, tmg.nsmooth, tmg.nsmooth_bottom, bcs, True, ncoef,
        jnp.float64, True)
    jv, jr = kern(jnp.asarray(v), jnp.asarray(f), *Cs[:top + 1])
    tv, tr = mg_kernel.core_plain(tmg, top, torch.as_tensor(v),
                                  torch.as_tensor(f), True)
    _close(jv, tv)
    _close(jr, tr, scale=_resid_scale(tmg, top, jv, f))

    v, f, vc = _frame(rng, 34, 0.1), _frame(rng, 34), _frame(rng, 18, 0.1)
    kern = pallas_gen_mg._make_down_kernel_g(fine, tmg.nsmooth, bcs, ncoef,
                                             jnp.float64, True)
    jv, jfc = kern(jnp.asarray(v), jnp.asarray(f), Cs[fine])
    tv, tfc = mg_kernel.down_plain(tmg, fine, torch.as_tensor(v),
                                   torch.as_tensor(f))
    _close(jv, tv)
    _close(jfc, tfc, scale=_resid_scale(tmg, fine, jv, f))

    kern = pallas_gen_mg._make_up_kernel_g(fine, tmg.nsmooth, bcs, True,
                                           ncoef, jnp.float64, True)
    jv, jr = kern(jnp.asarray(v), jnp.asarray(f), jnp.asarray(vc), Cs[fine])
    tv, tr = mg_kernel.up_plain(tmg, fine, torch.as_tensor(v),
                                torch.as_tensor(f), torch.as_tensor(vc),
                                True)
    _close(jv, tv)
    _close(jr, tr, scale=_resid_scale(tmg, fine, jv, f))


@pytest.mark.parametrize("kind", ["vc", "general"])
def test_peeled_cycle_matches_fused_pallas_cycle(kind, monkeypatch):
    """downs -> core -> ups with two peeled levels, against the JAX
    package's build_fused_cycle_general with the same split."""
    monkeypatch.setattr(pallas_mg, "CORE_MAX", 8)
    monkeypatch.setitem(mg_kernel.CORE_MAX, torch.float64, 8)
    JMG._CYCLE_CACHE.clear()
    jmg, tmg = _pair(kind, 32, "lm_atm" if kind == "vc" else "dirichlet")
    assert mg_kernel.split(tmg, torch.float64) == (2, [3, 4])
    g = tmg.soln_grid
    f = np.sin(2 * np.pi * g.x2d) * np.cos(4 * np.pi * g.y2d) + 0.3 * g.x2d
    fused = pallas_gen_mg.build_fused_cycle_general(jmg, interpret=True)
    jv, jr, _ = fused(jnp.zeros(f.shape), jnp.asarray(f), jmg._params())
    tv, tr = mg_kernel.cycle(tmg, torch.zeros(f.shape, dtype=torch.float64),
                             torch.as_tensor(f))
    _close(jv, tv)
    _close(jr, tr, scale=_resid_scale(tmg, tmg.nlevels - 1, jv, f))


# -- the kernel wrapper -------------------------------------------------------

@pytest.mark.parametrize("kind", ["vc", "general"])
def test_cpu_tensors_run_the_plain_versions_and_launches_raise(kind):
    _, tmg = _pair(kind, 16, "lm_atm")
    assert mg_kernel.check(tmg) == kind
    before = dict(mg_kernel.launches)
    rng = np.random.default_rng(5)
    v, f = torch.as_tensor(_frame(rng, 18)), torch.as_tensor(_frame(rng, 18))
    got = mg_kernel.cycle(tmg, v, f)
    ref = mg_kernel.core_plain(tmg, tmg.nlevels - 1, v, f, True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    for launch, args in ((mg_kernel.launch_core, (3, v, f, True)),
                         (mg_kernel.launch_down, (3, v, f)),
                         (mg_kernel.launch_up, (3, v, f, f[:10, :10], True))):
        with pytest.raises(ValueError, match="CUDA"):
            launch(tmg, *args)
    assert mg_kernel.launches == before


def test_flavour_dispatch_and_what_raises():
    _, vc = _vc_pair(16, "lm_atm")
    _, gen = _general_pair(16)
    const = MG.CellCenterMG2d(16, 16, device="cpu")
    assert [mg_kernel.flavour(m) for m in (const, vc, gen)] == \
        ["const", "vc", "general"]

    class Sub(VarCoeffCCMG2d):
        pass
    sub = Sub(16, 16, coeffs=np.ones((18, 18)), coeffs_bc=bnd.BC(),
              device="cpu")
    with pytest.raises(mg_kernel.Ineligible, match="A.10"):
        mg_kernel.check(sub)
    # inhomogeneous BC values run on the plain path only
    g = Grid2d(16, 16, ng=1)
    d = patch.CellCenterData2d(g, device="cpu")
    for name in ("alpha", "beta", "gamma_x", "gamma_y"):
        d.register_var(name, bnd.BC(xlb="neumann", xrb="neumann",
                                    ylb="neumann", yrb="neumann"))
    d.create()
    d.set_var("beta", np.ones((18, 18)))
    inhom = GeneralMG2d(16, 16, coeffs=d, xl_BC=lambda y: np.cos(y),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="A.6"):
        mg_kernel.check(inhom)


def test_work_counts_planes_and_operations():
    n, ns = 1024, 10
    b0, ops0 = mg_kernel.work("mg_down", n, ns, torch.float32)
    b, ops = mg_kernel.work("mg_down_vc", n, ns, torch.float32)
    assert b == b0 + 2 * 1026 ** 2 * 4
    assert ops == (13 * ns + 12) * n * n + 4 * 512 ** 2
    b, ops = mg_kernel.work("mg_up_general", n, ns, torch.float64)
    assert b == (4 * 1026 ** 2 + 514 ** 2 + 5 * 1026 ** 2) * 8
    assert ops == (9 + 17 * ns + 20) * n * n
    b, _ = mg_kernel.work("mg_core_vc", 2, ns, torch.float32,
                          with_guess=False, want_r=False)
    assert b == (2 * 16 + 2 * 16) * 4
    with pytest.raises(ValueError):
        mg_kernel.work("mg_down_other", n, ns, torch.float32)


def test_coefficient_mg_needs_a_device_or_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VarCoeffCCMG2d(16, 16, coeffs=np.ones((18, 18)), coeffs_bc=bnd.BC())
