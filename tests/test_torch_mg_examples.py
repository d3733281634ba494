"""The port's multigrid examples (pyro2_tpu_torch/multigrid/examples/), the
driver's analytic solves and the inhomogeneous BC values against
pyro2_tpu, on the CPU in float64.

* every analytic example at N = 32 against the JAX function at 32: L2
  errors within 1e-10 relative and equal cycle counts (both print them);
  project_periodic's divergence norms shrink, as JAX's test asserts, and
  equal JAX's within 1e-10; prolong_restrict_demo prints JAX's arrays;
  mg_vis returns JAX's residual history within 1e-10;
* the inhomogeneous general solve at 64^2 against JAX's jnp cycle: equal
  cycles, v within 1e-12 of max|v|;
* the CUDA route's formulation of BC values, run on the CPU: the plain
  entries with the finest level's homogeneous fill, fed the lifted
  right-hand side (mg_kernel.lifted_rhs), against the plain cycle that
  fills the values in place: one cycle within 1e-12 (v with its ghosts,
  and r to 1e-12 of the terms it cancels) and a solve with equal cycles,
  for Dirichlet and Neumann values under the three operators;
* the driver's MG_EXPECTED is JAX's, and `--multigrid_only` runs the
  four solves and passes them (at 64^2, against JAX's L2 errors there).
"""

import importlib
import re

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu import test as jtest
from pyro2_tpu_torch import test as ttest
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.multigrid import MG, mg_kernel
from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d
from pyro2_tpu_torch.multigrid.variable_coeff_MG import VarCoeffCCMG2d

ANALYTIC = [
    ("mg_test_simple", "test_poisson_dirichlet"),
    ("mg_test_vc_dirichlet", "test_vc_poisson_dirichlet"),
    ("mg_test_vc_periodic", "test_vc_poisson_periodic"),
    ("mg_test_vc_constant", "test_vc_poisson_constant"),
    ("mg_test_general_inhomogeneous", "test_general_poisson_inhomogeneous"),
    ("mg_test_general_constant", "test_general_poisson_constant"),
    ("mg_test_general_beta_only", "test_general_poisson_beta_only"),
    ("mg_test_general_alphabeta_only",
     "test_general_poisson_alphabeta_only"),
    ("mg_test_general_dirichlet", "test_general_poisson_dirichlet"),
]


def _example(package, module, fn=None):
    mod = importlib.import_module(f"{package}.multigrid.examples.{module}")
    return mod if fn is None else getattr(mod, fn)


def _cycles(text):
    return [int(c) for c in re.findall(r"cycles = (\d+)", text)]


@pytest.mark.parametrize("module,fn", ANALYTIC)
def test_analytic_example_matches_jax(module, fn, capsys):
    jerr = _example("pyro2_tpu", module, fn)(32)
    jout = capsys.readouterr().out
    terr = _example("pyro2_tpu_torch", module, fn)(32, device="cpu")
    tout = capsys.readouterr().out
    assert abs(terr - jerr) <= 1e-10 * jerr, (terr, jerr)
    assert _cycles(tout) == _cycles(jout) and len(_cycles(tout)) == 1


def test_project_periodic_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jdn = _example("pyro2_tpu", "project_periodic").doit(32, 32, nproj=2)
    jfile = tmp_path / "project-periodic.h5"
    jfile.rename(tmp_path / "jax.h5")
    dn = _example("pyro2_tpu_torch", "project_periodic").doit(
        32, 32, nproj=2, device="cpu")
    assert dn[1] < 0.2 * dn[0], dn
    np.testing.assert_allclose(dn, jdn, rtol=1e-10)
    # the port's file, read by h5py, holds JAX's state
    with h5py.File(tmp_path / "jax.h5") as jf, h5py.File(jfile) as tf:
        assert sorted(tf["state"]) == sorted(jf["state"])
        for name in jf["state"]:
            ref = jf["state"][name]["data"][()]
            np.testing.assert_allclose(tf["state"][name]["data"][()], ref,
                                       rtol=0, atol=1e-10 * max(
                                           1.0, np.abs(ref).max()))


def test_prolong_restrict_demo_prints_jax_arrays(capsys):
    _example("pyro2_tpu", "prolong_restrict_demo").doit()
    jout = capsys.readouterr().out
    _example("pyro2_tpu_torch", "prolong_restrict_demo").doit(device="cpu")
    assert capsys.readouterr().out == jout
    assert "10.5" in jout and "8.750" in jout


def test_mg_vis_matches_jax_history(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    jhist = _example("pyro2_tpu", "mg_vis").doit(32, 32, store_frames=False)
    hist = _example("pyro2_tpu_torch", "mg_vis").doit(32, 32,
                                                      store_frames=False,
                                                      device="cpu")
    assert len(hist) == len(jhist) > 3
    np.testing.assert_allclose(hist, jhist, rtol=1e-10)
    # one frame a cycle
    hist = _example("pyro2_tpu_torch", "mg_vis").doit(8, 8, device="cpu")
    assert len(list(tmp_path.glob("mg_vis_*.png"))) == len(hist)


def test_pretty_print_takes_one_component():
    g = Grid2d(4, 4, ng=1)
    with pytest.raises(ValueError, match="2-d"):
        ai(torch.zeros((2, g.qx, g.qy)), g).pretty_print()


def test_inhomogeneous_general_solve_matches_jnp_cycle():
    """JAX's GeneralMG2d on the CPU runs its jnp cycle (the Pallas kernels
    refuse BC values)."""
    from pyro2_tpu.mesh import patch as jpatch
    from pyro2_tpu.mesh.grid import Grid2d as JGrid2d
    from pyro2_tpu.multigrid.general_MG import GeneralMG2d as JGeneral

    ex = _example("pyro2_tpu_torch", "mg_test_general_inhomogeneous")
    n = 64
    g, jg = Grid2d(n, n, ng=1), JGrid2d(n, n, ng=1)
    vals = {"alpha": np.full((g.qx, g.qy), 10.0),
            "beta": g.x2d * g.y2d + 1.0,
            "gamma_x": np.ones((g.qx, g.qy)),
            "gamma_y": np.ones((g.qx, g.qy))}
    kw = dict(xl_BC_type="dirichlet", yl_BC_type="dirichlet",
              xr_BC_type="dirichlet", yr_BC_type="dirichlet",
              xl_BC=lambda y: np.cos(np.pi * y / 2.0),
              yl_BC=lambda x: np.cos(np.pi * x / 2.0), verbose=0)
    solved = []
    for d, cls, extra in (
            (jpatch.CellCenterData2d(jg), JGeneral, {}),
            (patch.CellCenterData2d(g, device="cpu"), GeneralMG2d,
             {"device": "cpu"})):
        for name in vals:
            d.register_var(name, bnd.BC(xlb="neumann", xrb="neumann",
                                        ylb="neumann", yrb="neumann")
                           if cls is GeneralMG2d else
                           _jbc(("neumann",) * 4))
        d.create()
        for name, a in vals.items():
            d.set_var(name, a if cls is GeneralMG2d else jnp.asarray(a))
        mg = cls(n, n, coeffs=d, **kw, **extra)
        mg.init_zeros()
        f = ex.f(mg.x2d, mg.y2d)
        mg.init_RHS(f if cls is GeneralMG2d else jnp.asarray(f))
        mg.solve(rtol=1e-11)
        solved.append(mg)
    jmg, tmg = solved
    assert tmg.num_cycles == jmg.num_cycles
    jv = np.asarray(jmg.get_solution())
    tv = tmg.get_solution().numpy()
    assert np.abs(tv - jv).max() <= 1e-12 * np.abs(jv).max()


def _jbc(kinds):
    import pyro2_tpu.mesh.boundary as jbnd
    return jbnd.BC(xlb=kinds[0], xrb=kinds[1], ylb=kinds[2], yrb=kinds[3])


# -- the lift of BC values into the right-hand side ---------------------------

# the edges (x-lo, x-hi, y-lo, y-hi) of each kind of values: Neumann on
# three edges (both signs of the offset), and one Dirichlet edge that
# keeps the coefficient operator's solve well posed
EDGES = {"dirichlet": ("dirichlet",) * 4,
         "neumann": ("neumann", "neumann", "dirichlet", "neumann")}


def _values_mg(op, kind, n):
    """An n^2 MG of operator op whose edges carry values (set on the
    finest level's BC, as GeneralMG2d's constructor does; the
    VarCoeffCCMG2d constructor takes none)."""
    g = Grid2d(n, n, ng=1)
    e = EDGES[kind]
    kw = dict(xl_BC_type=e[0], xr_BC_type=e[1], yl_BC_type=e[2],
              yr_BC_type=e[3], device="cpu")
    if op == "const":
        mg = MG.CellCenterMG2d(n, n, alpha=1.0, beta=(1.0 / n) ** 2, **kw)
    elif op == "vc":
        mg = VarCoeffCCMG2d(
            n, n, coeffs=2.0 + np.cos(2 * np.pi * g.x2d) *
            np.cos(2 * np.pi * g.y2d), coeffs_bc=bnd.BC(
                xlb="neumann", xrb="neumann", ylb="neumann", yrb="neumann"),
            **kw)
    else:
        d = patch.CellCenterData2d(g, device="cpu")
        for name in ("alpha", "beta", "gamma_x", "gamma_y"):
            d.register_var(name, bnd.BC(xlb="neumann", xrb="neumann",
                                        ylb="neumann", yrb="neumann"))
        d.create()
        d.set_var("alpha", np.full((g.qx, g.qy), -1.0))
        d.set_var("beta", g.x2d * g.y2d + 1.0)
        d.set_var("gamma_x", np.ones((g.qx, g.qy)))
        d.set_var("gamma_y", 0.5 + g.x2d)
        mg = GeneralMG2d(n, n, coeffs=d, **kw)
    mg.bc_v[-1] = bnd.BC(xlb=e[0], xrb=e[1], ylb=e[2], yrb=e[3],
                         xl_func=lambda y: np.cos(np.pi * y),
                         xr_func=lambda y: 1.0 + y,
                         yl_func=lambda x: x ** 2,
                         yr_func=lambda x: -np.sin(3.0 * x),
                         grid=mg.grids[-1])
    return mg


def _resid_scale(mg, v, f):
    vmax, fmax = float(v.abs().max()), float(f.abs().max())
    if mg_kernel.flavour(mg) == "const":
        return fmax + (abs(mg.alpha) + 8.0 * abs(mg.beta) /
                       mg.soln_grid.dx ** 2) * vmax
    return fmax + 8.0 * float(mg.planes[-1].abs().max()) * vmax


@pytest.mark.parametrize("kind", ["dirichlet", "neumann"])
@pytest.mark.parametrize("op", ["const", "vc", "general"])
def test_lifted_rhs_equals_in_cycle_fill(op, kind, monkeypatch):
    n = 64
    mg = _values_mg(op, kind, n)
    assert mg_kernel.check(mg) == op           # values are taken
    rng = np.random.default_rng(11)
    v = torch.as_tensor(0.1 * rng.standard_normal((n + 2, n + 2)))
    f = torch.as_tensor(rng.standard_normal((n + 2, n + 2)))
    v0, f0 = v.clone(), f.clone()

    f_h = mg_kernel.lifted_rhs(mg, f)
    # the lift changes only the boundary cells' right-hand side
    inner = (slice(2, -2), slice(2, -2))
    assert torch.equal(f_h[inner], f[inner])
    assert not torch.equal(f_h, f)

    ref = mg_kernel.cycle(mg, v, f)                # the values filled
    got = mg_kernel.cycle(mg, v, f, f_h)           # the CUDA route's
    assert torch.equal(v, v0) and torch.equal(f, f0)
    vmax = float(ref[0].abs().max())
    assert float((ref[0] - got[0]).abs().max()) <= 1e-12 * vmax
    assert float((ref[1] - got[1]).abs().max()) <= \
        1e-12 * _resid_scale(mg, ref[0], f)
    # the refill: the ghosts are the values' fill of the same interior
    refill = mg._fill_v(mg.nlevels - 1, ref[0].clone())
    assert torch.equal(ref[0], refill)

    # a whole solve through the lifted route, against the plain one
    solves = []
    cycle = mg_kernel.cycle
    for lifted in (False, True):
        m = _values_mg(op, kind, n)
        m.init_zeros()
        m.init_RHS(f)
        if lifted:
            monkeypatch.setattr(
                mg_kernel, "cycle", lambda mm, vv, ff, f_h=None: cycle(
                    mm, vv, ff, mg_kernel.lifted_rhs(mm, ff)))
        m.solve(rtol=1e-11)
        monkeypatch.setattr(mg_kernel, "cycle", cycle)
        solves.append(m)
    ref_m, got_m = solves
    assert got_m.num_cycles == ref_m.num_cycles
    assert got_m.source_norm == ref_m.source_norm
    # the residual errors are relative to ||f||: at the float64 floor
    # they agree to roundoff of that size
    assert got_m.residual_error < 1e-11
    assert abs(got_m.residual_error - ref_m.residual_error) <= 1e-13
    sol = ref_m.get_solution()
    assert float((got_m.get_solution() - sol).abs().max()) <= \
        1e-12 * float(sol.abs().max())


def test_multigrid_only_driver_passes(capsys, monkeypatch):
    """The driver's table is JAX's (published N = 256, expected L2
    errors), and --multigrid_only runs the four solves and passes them.
    At 256^2 the four plain solves take ~5 s alone here but minutes among
    the tier-1 run's workers, so the driver runs them at 64^2 against
    JAX's L2 errors at 64^2."""
    assert set(ttest.MG_EXPECTED) == set(jtest.MG_EXPECTED)
    small = {}
    for name, (n, jfn, expected) in jtest.MG_EXPECTED.items():
        tn, fn, texpected = ttest.MG_EXPECTED[name]
        assert (tn, texpected) == (n, expected)
        assert fn.__name__ == jfn.__name__
        small[name] = (64, fn, jfn(64))
    capsys.readouterr()
    monkeypatch.setattr(ttest, "MG_EXPECTED", small)
    assert ttest.do_tests(None, multigrid_only=True, device="cpu") == 0
    out = capsys.readouterr().out
    for name in ttest.MG_EXPECTED:
        assert re.search(rf"{name}\s+passed", out), out
    assert "0 test(s) failed" in out and "running" not in out
