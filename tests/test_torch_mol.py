"""Parity of the PyTorch port's method-of-lines compressible tier
(compressible_rk, compressible_fv4, compressible_sdc) with pyro2_tpu.

The same states, set up by pyro2_tpu's own problems and perturbed from a
numpy seed, go through the JAX functions (CPU, x64, tests/conftest.py) and
their counterparts in pyro2_tpu_torch (CPU, float64).  Tolerances:
  * one plain stage increment k against the JAX jnp substep
    (jax.jit(sim._make_substep())) from the same carried state:
    max|dk| <= 1e-12 (max|F_x|/dx + max|F_y|/dy + max|S|), the size of the
    terms k cancels; k is exactly zero on every ghost;
  * a few Pyro steps of each solver: dt sequences to 1e-12, state to
    1e-10 max|U|;
  * the MOL CFL dt, which takes its minimum over every cell, ghosts
    included: to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.mesh import patch as tpatch
from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel
from pyro2_tpu_torch.util.carry import carry_simulation

WALLS = {"mesh.xlboundary": "reflect", "mesh.xrboundary": "reflect",
         "mesh.ylboundary": "reflect", "mesh.yrboundary": "reflect"}

# one stage increment each: (solver, problem, inputs, extra passive scalars)
SUBSTEP_CASES = {
    "rk_quad_hllc": ("compressible_rk", "quad",
                     {"mesh.nx": 20, "mesh.ny": 36}, None),
    "rk_kh_hllc_lm_periodic": ("compressible_rk", "kh", {
        "mesh.nx": 32, "mesh.ny": 24, "compressible.riemann": "HLLC_lm"},
        None),
    "rk_rt_gravity_hse": ("compressible_rk", "rt",
                          {"mesh.nx": 16, "mesh.ny": 48}, None),
    "rk_walls_floor_sponge_scalar": ("compressible_rk", "quad", {
        "mesh.nx": 20, "mesh.ny": 36, **WALLS,
        "compressible.riemann": "CGF", "compressible.small_dens": 0.2,
        "compressible.grav": -0.5, "sponge.do_sponge": 1,
        "sponge.sponge_rho_begin": 0.6, "sponge.sponge_rho_full": 0.3},
        ["passive"]),
    "fv4_acoustic_pulse": ("compressible_fv4", "acoustic_pulse",
                           {"mesh.nx": 24, "mesh.ny": 24}, None),
    "fv4_kh": ("compressible_fv4", "kh", {"mesh.nx": 24, "mesh.ny": 24},
               None),
    "fv4_rt_gravity": ("compressible_fv4", "rt",
                       {"mesh.nx": 16, "mesh.ny": 48}, None),
    # a low-density spike, whose cell centres have negative density (the
    # `bad` fallback), and a sheared patch whose 4th-order average
    # pressure is not positive (the q_avg fallback)
    "fv4_positivity_fallbacks": ("compressible_fv4", "kh",
                                 {"mesh.nx": 24, "mesh.ny": 24}, "rough"),
}


def _lap5(a, i, j):
    return a[i - 1, j] + a[i + 1, j] + a[i, j - 1] + a[i, j + 1] - 4 * a[i, j]


def _sheared_patch(gamma):
    """A 5x5 patch of (rho, u, v, p) averages, the first of a seeded random
    search, whose centre cell is not `bad` but whose 4th-order average
    pressure p_cc + dx^2/24 lap(p_bar) is not positive."""
    rng = np.random.default_rng(0)
    g1 = gamma - 1.0
    while True:
        rho = np.exp(rng.normal(0, 0.7, (5, 5)))
        u, v = rng.normal(0, 2, (5, 5)), rng.normal(0, 2, (5, 5))
        p = np.exp(rng.normal(0, 1.0, (5, 5)))
        ke = 0.5 * rho * (u * u + v * v)
        E, mx, my = p / g1 + ke, rho * u, rho * v
        cc = {}
        for c in ((2, 2), (1, 2), (3, 2), (2, 1), (2, 3)):
            r, X, Y, e = (a[c] - _lap5(a, *c) / 24 for a in (rho, mx, my, E))
            cc[c] = (r, e - 0.5 * (X * X + Y * Y) / r)
        if all(r >= 0 and rhoe >= 0 for r, rhoe in cc.values()):
            p_bar = g1 * (E - 0.5 * (mx * mx + my * my) / rho)
            if g1 * cc[2, 2][1] + _lap5(p_bar, 2, 2) / 24 <= 0:
                return rho, u, v, p


def _jax_sim(solver, problem, inputs, extra_vars=None, seed=0):
    """A pyro2_tpu Simulation set up by Pyro (fv4: averages), with seeded
    velocity noise (and random passive scalars), ghosts filled.
    extra_vars="rough" instead makes the density log-normal at the same
    velocity and pressure."""
    rough = extra_vars == "rough"
    if rough:
        extra_vars = None
    p = JPyro(solver)
    p.initialize_problem(problem, inputs_dict=inputs)
    sim = p.sim
    if extra_vars:
        sim = type(p.sim)(solver, problem, p.problem_func, p.rp)
        sim.initialize(extra_vars=extra_vars)
        sim.preevolve()
    rng = np.random.default_rng(seed)
    U = np.array(sim.cc_data.data)
    iv = sim.ivars
    for n in (iv.ixmom, iv.iymom):
        U[n] += 0.05 * U[iv.idens] * rng.standard_normal(U[n].shape)
    for n in range(4, iv.nvar):
        U[n] = U[iv.idens] * rng.random(U[n].shape)
    if rough:
        g1 = sim.rp.get_param("eos.gamma") - 1.0
        rho, u, v, p = _sheared_patch(g1 + 1.0)
        w = (slice(8, 13), slice(8, 13))
        U[iv.idens][w], U[iv.ixmom][w], U[iv.iymom][w] = rho, rho * u, \
            rho * v
        U[iv.iener][w] = p / g1 + 0.5 * rho * (u * u + v * v)
        c = (18, 20)         # the spike: density x 0.02 at the same u, p
        ke = 0.5 * (U[iv.ixmom][c] ** 2 + U[iv.iymom][c] ** 2) / U[iv.idens][c]
        p_c = g1 * (U[iv.iener][c] - ke)
        for n in (iv.idens, iv.ixmom, iv.iymom):
            U[n][c] *= 0.02
        U[iv.iener][c] = p_c / g1 + 0.02 * ke
    sim.cc_data.data = jnp.asarray(U)
    sim.cc_data.t = 0.0
    sim.cc_data.fill_BC_all()
    return sim


def _torch_sim(jsim, extra_vars=None):
    return carry_simulation(jsim.solver_name, jsim.problem_name,
                            jsim.rp.params, np.asarray(jsim.cc_data.data),
                            extra_vars=extra_vars, device="cpu")


def _ghost_mask(g):
    m = np.ones((g.qx, g.qy), bool)
    m[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = False
    return m


@pytest.fixture(scope="module", params=list(SUBSTEP_CASES))
def substep_pair(request):
    solver, problem, inputs, extra = SUBSTEP_CASES[request.param]
    jsim = _jax_sim(solver, problem, inputs, extra)
    jsim.method_compute_timestep()
    tsim = _torch_sim(jsim, None if extra == "rough" else extra)
    return request.param, jsim, tsim


def test_plain_substep_matches_jax(substep_pair):
    case, jsim, tsim = substep_pair
    t, dt = 0.0, jsim.dt
    kj = np.asarray(jax.jit(jsim._make_substep())(jsim.cc_data.data, t, dt))
    U0 = tsim.cc_data.data.clone()
    kt = tsim._make_substep()(tsim.cc_data.data, t, dt)
    assert torch.equal(tsim.cc_data.data, U0)      # the substep is pure
    kind = tsim.MOL_KIND
    scale = mol_kernel.increment_scale(tsim, kind, U0, t, dt)
    err = np.abs(kt.numpy() - kj).max()
    assert err <= 1e-12 * scale, (err, scale)
    g = tsim.cc_data.grid
    assert not kt[:, _ghost_mask(g)].any()
    assert np.abs(kj).max() > 1e-3 * scale        # k is not trivially small

    # the kernel wrapper takes the plain version for CPU tensors
    step = tsim._step
    assert isinstance(step, mol_kernel.MOLSubstep) and step.kind == kind
    before = dict(mol_kernel.launches)
    assert torch.equal(step(tsim.cc_data.data, t, dt), kt)
    assert mol_kernel.launches == before
    if case == "rk_walls_floor_sponge_scalar":
        # the floor and the sponge have zones to act on
        d = U0[0, g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]
        assert float(d.min()) < 0.2 < 0.6 < float(d.max())
    if case == "fv4_positivity_fallbacks":
        # the `bad` fallback has cells to act on
        from pyro2_tpu_torch.mesh.fv import to_centers_array
        iv = tsim.ivars
        U_cc = to_centers_array(U0, g)
        rhoe = U_cc[iv.iener] - 0.5 * (U_cc[iv.ixmom] ** 2 +
                                       U_cc[iv.iymom] ** 2) / U_cc[iv.idens]
        assert bool((U_cc[iv.idens] < 0).any() and (rhoe < 0).any())


def test_no_ctu_step_on_mol_paths(substep_pair):
    _case, _jsim, tsim = substep_pair
    from pyro2_tpu_torch.solvers.compressible.ctu_kernel import CTUStep
    assert not isinstance(tsim._step, CTUStep)


# -- the MOL CFL rule ---------------------------------------------------------

@pytest.mark.parametrize("solver", ["compressible_rk", "compressible_fv4"])
def test_dt_matches_jax_ghosts_included(solver):
    inputs = {"mesh.nx": 16, "mesh.ny": 16, "driver.fix_dt": -1.0}
    jsim = _jax_sim(solver, "kh", inputs)
    U = np.array(jsim.cc_data.data)
    g = jsim.cc_data.grid
    iv, c = jsim.ivars, (1, g.jlo + 3)          # an x ghost cell
    U[(iv.ixmom,) + c] += 40.0 * U[(iv.idens,) + c]
    U[(iv.iener,) + c] += 800.0 * U[(iv.idens,) + c]
    dts = []
    for Ux in (np.asarray(jsim.cc_data.data), U):
        jsim.cc_data.data = jnp.asarray(Ux)
        jsim.method_compute_timestep()
        tsim = _torch_sim(jsim)
        tsim.method_compute_timestep()
        assert abs(tsim.dt - jsim.dt) <= 1e-12 * jsim.dt
        dts.append(tsim.dt)
    assert dts[1] < 0.5 * dts[0]      # the ghost cell sets the minimum


# -- whole runs ---------------------------------------------------------------

RUN_CASES = {
    "rk_quad": ("compressible_rk", "quad",
                {"mesh.nx": 24, "mesh.ny": 32}, 6),
    "rk_rt_tvd3": ("compressible_rk", "rt", {
        "mesh.nx": 16, "mesh.ny": 48,
        "compressible.temporal_method": "TVD3"}, 4),
    "fv4_kh": ("compressible_fv4", "kh", {"mesh.nx": 16, "mesh.ny": 16}, 5),
    "sdc_acoustic_pulse": ("compressible_sdc", "acoustic_pulse", {
        "mesh.nx": 16, "mesh.ny": 16, "driver.fix_dt": -1.0}, 3),
}


def _interior(U, g):
    U = U.numpy() if isinstance(U, torch.Tensor) else np.asarray(U)
    return U[:, g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_pyro_steps_match_jax(case):
    solver, problem, inputs, steps = RUN_CASES[case]
    inputs = {**inputs, "driver.max_steps": steps, "driver.tmax": 10.0}
    pj = JPyro(solver)
    pj.initialize_problem(problem, inputs_dict=inputs)
    pt = Pyro(solver, device="cpu")
    pt.initialize_problem(problem, inputs_dict=inputs)
    g = pt.sim.cc_data.grid
    # the initial state (fv4, sdc: preevolve's cell averages)
    a0 = _interior(pj.sim.cc_data.data, g)
    assert np.abs(_interior(pt.sim.cc_data.data, g) - a0).max() <= \
        1e-14 * np.abs(a0).max()
    dts_j, dts_t = [], []
    for _ in range(steps):
        pj.single_step()
        pt.single_step()
        dts_j.append(pj.sim.dt)
        dts_t.append(pt.sim.dt)
    np.testing.assert_allclose(dts_t, dts_j, rtol=1e-12, atol=0)
    assert pt.sim.n == steps
    a = _interior(pj.sim.cc_data.data, g)
    b = _interior(pt.sim.cc_data.data, g)
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    assert pt.sim.cc_data.t == pytest.approx(pj.sim.cc_data.t, rel=1e-12)


def test_sharing_clone_changes_the_result(monkeypatch):
    """The RK stage starts accumulate in place into a clone of the start.
    A clone that shared the start's tensor (as JAX's clone shares its
    immutable array) would leak every stage into the start: the port's
    clone copies it, and this test shows the difference."""
    inputs = {"mesh.nx": 16, "mesh.ny": 16, "driver.max_steps": 1,
              "driver.tmax": 10.0}

    def one_step():
        p = Pyro("compressible_rk", device="cpu")
        p.initialize_problem("kh", inputs_dict=inputs)
        p.run_sim()
        return p.sim.cc_data.data.clone()

    good = one_step()
    real_clone = tpatch.cell_center_data_clone

    def sharing_clone(old):
        new = real_clone(old)
        new.data = old.data
        return new

    monkeypatch.setattr(tpatch, "cell_center_data_clone", sharing_clone)
    bad = one_step()
    assert (bad - good).abs().max() > 1e-6 * good.abs().max()


# -- no fallback --------------------------------------------------------------

def test_launch_refuses_cpu_tensors():
    jsim = _jax_sim(*SUBSTEP_CASES["fv4_kh"][:3])
    tsim = _torch_sim(jsim)
    step = tsim._step
    U = tsim.cc_data.data
    before = dict(mol_kernel.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        step.launch(U, 0.0, 1e-4)
    with pytest.raises(TypeError):
        step(U.to(torch.float16), 0.0, 1e-4)
    with pytest.raises(ValueError):
        step(U[:, 1:, :].contiguous(), 0.0, 1e-4)
    with pytest.raises(ValueError):
        step(U.permute(0, 2, 1).contiguous().permute(0, 2, 1), 0.0, 1e-4)
    with pytest.raises(ValueError):
        step(torch.empty(U.shape, dtype=U.dtype, device="meta"), 0.0, 1e-4)
    assert mol_kernel.launches == before


@pytest.mark.parametrize("solver", ["compressible_rk", "compressible_fv4",
                                    "compressible_sdc"])
def test_uncovered_configurations_raise(solver):
    """Spherical grids run in the MOL tier with the one Riemann solver the
    CTU solver takes there (with compressible_rk's default HLLC, initialize
    fails first, as the JAX package's does).  A problem source that is not
    an energy rate rho e_rate w(x, y) steps on the CPU and the kernel's
    launch refuses it naming A.27; the well-balanced reconstruction with a
    limiter other than 1 fails as the JAX package's does, in the plain
    stage and in the launch (both before the device is looked at)."""
    spherical = {"mesh.nx": 16, "mesh.ny": 16,
                 "mesh.grid_type": "SphericalPolar",
                 "mesh.xmin": 0.5, "mesh.xmax": 1.0,
                 "mesh.ymin": 0.7853981633974483,
                 "mesh.ymax": 0.7853981633974483 + 0.5}
    pt = Pyro(solver, device="cpu")
    pt.initialize_problem("advect", inputs_dict={
        **spherical, "compressible.riemann": "CGF"})
    pt.single_step()
    assert pt.sim._step.spherical
    if solver == "compressible_rk":
        pt = Pyro(solver, device="cpu")
        with pytest.raises(RuntimeError, match="HLLC Riemann Solver is not "
                           "supported with SphericalPolar"):
            pt.initialize_problem("advect", inputs_dict=spherical)
    pt = Pyro(solver, device="cpu")
    pt.initialize_problem("acoustic_pulse", inputs_dict={"mesh.nx": 16,
                                                          "mesh.ny": 16})
    sim = type(pt.sim)(solver, "acoustic_pulse", pt.problem_func, pt.rp,
                       problem_source_func=lambda *a: 0.0, device="cpu")
    sim.initialize()
    U = sim.cc_data.data
    assert sim._step(U, 0.0, 1e-4).shape == U.shape    # the plain stage
    with pytest.raises(NotImplementedError,
                       match=r"problem source .*ROADMAP\.md A\.27"):
        sim._step.launch(U, 0.0, 1e-4)
    if solver == "compressible_rk":
        pt = Pyro(solver, device="cpu")
        pt.initialize_problem("rt", inputs_dict={
            "mesh.nx": 16, "mesh.ny": 48,
            "compressible.well_balanced": 1})
        U = pt.sim.cc_data.data
        with pytest.raises(ValueError, match="limiter == 1"):
            pt.sim._step(U, 0.0, 1e-4)
        with pytest.raises(ValueError, match="limiter == 1"):
            pt.sim._step.launch(U, 0.0, 1e-4)


def test_f32_plain_fv4_substep_matches_pallas_interpret():
    """The port's plain fv4 substep in float32 against the TPU kernel
    (make_pallas_fv4_substep) run in interpret mode, from the same state:
    1e-5 of the increment scale (float32 rounding through one stage)."""
    from pyro2_tpu.solvers.compressible_fv4.pallas_step import \
        make_pallas_fv4_substep

    jsim = _jax_sim("compressible_fv4", "acoustic_pulse",
                    {"mesh.nx": 16, "mesh.ny": 16})
    U0 = jsim.cc_data.data.astype(jnp.float32)
    dt = 1e-3
    k_p = np.asarray(make_pallas_fv4_substep(jsim, interpret=True)(
        U0, 0.0, jnp.asarray(dt, jnp.float32)))
    tsim = carry_simulation("compressible_fv4", "acoustic_pulse",
                            jsim.rp.params, np.asarray(U0),
                            device="cpu", dtype=torch.float32)
    U = tsim.cc_data.data
    assert U.dtype == torch.float32
    k_t = tsim._make_substep()(U, 0.0, dt)
    scale = mol_kernel.increment_scale(tsim, "fv4", U, 0.0, dt)
    assert np.abs(k_t.numpy() - k_p).max() <= 1e-5 * scale


@pytest.mark.parametrize("small_dens", [-1.e200, 0.2])
def test_density_floor_sentinel_is_clamped(small_dens):
    """The default floor (-1e200) is out of float32 range: the kernel's
    arguments clamp it to finfo(float32).min and switch the floor off, and
    the plain float32 increment runs without an overflow; a positive
    floor stays on."""
    import warnings

    jsim = _jax_sim("compressible_rk", "quad",
                    {"mesh.nx": 16, "mesh.ny": 16,
                     "compressible.small_dens": small_dens})
    tsim = carry_simulation("compressible_rk", "quad", jsim.rp.params,
                            np.asarray(jsim.cc_data.data),
                            device="cpu", dtype=torch.float32)
    U = tsim.cc_data.data
    ints, doubles = tsim._step.kernel_args(U, 1e-3)
    f32_min = float(torch.finfo(torch.float32).min)
    if small_dens < 0:
        assert ints[13] == 0 and doubles[8] == f32_min
    else:
        assert ints[13] == 1 and doubles[8] == small_dens
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        k = tsim._make_substep()(U, 0.0, 1e-3)
    assert bool(torch.isfinite(k).all())
