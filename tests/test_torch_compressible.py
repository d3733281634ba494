"""Parity of the PyTorch port's compressible CTU solver with pyro2_tpu.

The same inputs, made from a numpy seed or by pyro2_tpu's own problem
setup, go through the JAX functions (CPU, x64, tests/conftest.py) and their
counterparts in pyro2_tpu_torch (CPU, float64).  Tolerances:
  * unit stages (tracing, Riemann solvers, artificial viscosity): rtol 1e-12;
  * one full plain step vs sim._make_step(): max |diff| <= 1e-12 max|U| on
    the interior (the kernel path carries ghosts through unchanged, the jnp
    sponge touches them, so only interiors are compared);
  * 20 Pyro steps of quad: dt sequences to 1e-12, state to 1e-10 max|U|;
  * one float32 plain step vs the Pallas kernel in interpret mode: 1e-5
    max|U| (float32 rounding through one CTU step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu.mesh.grid import Cartesian2d as JCartesian2d
from pyro2_tpu.solvers.compressible import interface as jifc
from pyro2_tpu.solvers.compressible import riemann as jriemann
from pyro2_tpu.solvers.compressible.simulation import Simulation as JSim
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.mesh.grid import Cartesian2d
from pyro2_tpu_torch.solvers.compressible import ctu_kernel
from pyro2_tpu_torch.solvers.compressible import interface as tifc
from pyro2_tpu_torch.solvers.compressible import riemann as triemann
from pyro2_tpu_torch.solvers.compressible import simulation as tcomp
from pyro2_tpu_torch.solvers.compressible.problems import (kh, quad, rt,
                                                           sod)
from pyro2_tpu_torch.util.carry import carry

GAMMA = 1.4
PROBLEMS = {"sod": sod, "quad": quad, "kh": kh, "rt": rt}


class IV:
    """Variable indices with one passive scalar (nvar = 5), in the
    registration order of the Simulation (density, energy, x-, y-mom)."""
    nvar = 5
    idens, iener, ixmom, iymom = 0, 1, 2, 3
    naux = 1
    irhox = 4
    nq = 5
    irho, iu, iv, ip = 0, 1, 2, 3
    ix = 4


def _random_prims(g, rng, zero_u=False):
    shape = (g.qx, g.qy)
    rho = 0.5 + rng.random(shape)
    u = rng.standard_normal(shape)
    v = rng.standard_normal(shape)
    if zero_u:
        # stationary waves: ev == 0 gates fully left
        u[::2, :] = 0.0
        v[:, ::2] = 0.0
    p = 0.5 + rng.random(shape)
    X = rng.random(shape)
    return np.stack([rho, u, v, p, X])


def _cons(q):
    rho, u, v, p, X = q
    ener = p / (GAMMA - 1.0) + 0.5 * rho * (u * u + v * v)
    return np.stack([rho, ener, rho * u, rho * v, rho * X])


def _close(a, b, rtol=1e-12):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    scale = max(np.abs(a).max(), 1e-300)
    np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol * scale)


# -- stage units ------------------------------------------------------------

@pytest.mark.parametrize("idir", [1, 2])
@pytest.mark.parametrize("nx,ny", [(32, 24), (20, 36)])
def test_states_match_jax(idir, nx, ny):
    rng = np.random.default_rng(10 * idir + nx)
    jg = JCartesian2d(nx, ny, ng=4)
    tg = Cartesian2d(nx, ny, ng=4)
    q = _random_prims(tg, rng, zero_u=True)
    dq = 0.1 * rng.standard_normal(q.shape)
    dt = 1e-3
    dxa = tg.dx if idir == 1 else tg.dy
    jl, jr = jifc.states(idir, jg, dxa, 0.0, dt, IV, GAMMA,
                         jnp.asarray(q), jnp.asarray(dq))
    tl, tr = tifc.states(idir, tg, dxa, 0.0, dt, IV, GAMMA,
                         torch.as_tensor(q), torch.as_tensor(dq))
    _close(jl, tl)
    _close(jr, tr)


@pytest.mark.parametrize("solver", ["HLLC", "HLLC_lm", "CGF"])
@pytest.mark.parametrize("idir", [1, 2])
@pytest.mark.parametrize("walls", [(0, 0), (1, 1)])
def test_riemann_matches_jax(solver, idir, walls):
    rng = np.random.default_rng(7)
    nx, ny = 20, 36
    jg = JCartesian2d(nx, ny, ng=4)
    tg = Cartesian2d(nx, ny, ng=4)
    q_l = _random_prims(tg, rng)
    q_r = _random_prims(tg, rng)
    # strong pressure jumps exercise the 2-shock / 2-rarefaction upgrades
    q_r[3, ::3] *= 8.0
    q_l[3, 1::3] *= 8.0
    U_l, U_r = _cons(q_l), _cons(q_r)
    jf = {"HLLC": jriemann.riemann_hllc,
          "HLLC_lm": jriemann.riemann_hllc_lowspeed,
          "CGF": jriemann.riemann_cgf}
    ja = jf[solver](idir, jg, IV, walls[0], walls[1], GAMMA,
                    jnp.asarray(U_l), jnp.asarray(U_r))
    ta = triemann.SOLVERS[solver](idir, tg, IV, walls[0], walls[1], GAMMA,
                                  torch.as_tensor(U_l),
                                  torch.as_tensor(U_r))
    if solver == "CGF":
        ja = jriemann.consFlux(idir, 0, GAMMA, IV, ja)
        ta = triemann.consFlux(idir, 0, GAMMA, IV, ta)
    _close(ja, ta)


def test_artificial_viscosity_matches_jax():
    rng = np.random.default_rng(3)
    jg = JCartesian2d(20, 36, ng=4)
    tg = Cartesian2d(20, 36, ng=4)
    u = rng.standard_normal((tg.qx, tg.qy))
    v = rng.standard_normal((tg.qx, tg.qy))
    jx, jy = jifc.artificial_viscosity(jg, 0.1, jnp.asarray(u),
                                       jnp.asarray(v))
    tx, ty = tifc.artificial_viscosity(tg, 0.1, torch.as_tensor(u),
                                       torch.as_tensor(v))
    _close(jx, tx)
    _close(jy, ty)


def test_cons_to_prim_checks_only_when_asked():
    tg = Cartesian2d(8, 8, ng=4)
    rng = np.random.default_rng(0)
    U = torch.as_tensor(_cons(_random_prims(tg, rng)))
    U[1, 6, 6] = -1.0       # negative energy in an interior zone
    with pytest.raises(ValueError, match="invalid state"):
        tcomp.cons_to_prim(U, GAMMA, IV, tg)
    q = tcomp.cons_to_prim(U, GAMMA, IV, tg, check=False)
    assert q.shape == U.shape


# -- one full step ------------------------------------------------------------

STEP_CASES = {
    "sod_cgf": ("sod", {"mesh.nx": 32, "mesh.ny": 24,
                        "compressible.riemann": "CGF"}, None),
    "quad_hllc": ("quad", {"mesh.nx": 20, "mesh.ny": 36}, None),
    "kh_hllc_lm": ("kh", {"mesh.nx": 32, "mesh.ny": 24,
                          "compressible.riemann": "HLLC_lm"}, None),
    "rt_gravity_hse": ("rt", {"mesh.nx": 20, "mesh.ny": 36}, None),
    "walls_floor_sponge": ("quad", {
        "mesh.nx": 20, "mesh.ny": 36,
        "mesh.xlboundary": "reflect", "mesh.xrboundary": "reflect",
        "mesh.ylboundary": "reflect", "mesh.yrboundary": "reflect",
        "compressible.riemann": "CGF", "compressible.small_dens": 0.2,
        "compressible.grav": -0.5,
        "sponge.do_sponge": 1, "sponge.sponge_rho_begin": 0.6,
        "sponge.sponge_rho_full": 0.3}, ["passive"]),
}


def _jax_sim(problem, inputs, extra_vars=None):
    p = JPyro("compressible")
    p.initialize_problem(problem, inputs_dict=inputs)
    sim = p.sim
    if extra_vars:
        sim = JSim("compressible", problem, p.problem_func, p.rp)
        sim.initialize(extra_vars=extra_vars)
        rng = np.random.default_rng(5)
        dens = np.asarray(sim.cc_data.get_var("density"))
        for name in extra_vars:
            sim.cc_data.set_var(name, dens * rng.random(dens.shape))
    sim.cc_data.t = 0.0
    sim.cc_data.fill_BC_all()
    return sim


def _torch_sim(jsim, dtype=torch.float64):
    rp, U = carry(jsim.rp.params, np.asarray(jsim.cc_data.data),
                  device="cpu", dtype=dtype)
    problem = PROBLEMS[jsim.problem_name]
    sim = tcomp.Simulation("compressible", jsim.problem_name,
                           problem.init_data, rp, device="cpu", dtype=dtype)
    extra = jsim.cc_data.names[4:]
    sim.initialize(extra_vars=extra or None)
    sim.cc_data.set_vars(U)
    sim.cc_data.t = 0.0
    return sim


def _interior(U, g):
    U = U.numpy() if isinstance(U, torch.Tensor) else np.asarray(U)
    return U[:, g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_plain_step_matches_jax(case):
    problem, inputs, extra = STEP_CASES[case]
    jsim = _jax_sim(problem, inputs, extra)
    tsim = _torch_sim(jsim)
    g = tsim.cc_data.grid

    dt = 0.8 * float(jsim._make_dt()(jsim.cc_data.data))
    t = 0.0
    Uj = jax.jit(jsim._make_step())(jsim.cc_data.data, t, dt)
    U0 = tsim.cc_data.data.clone()
    Ut = tsim._make_step()(tsim.cc_data.data, t, dt)
    assert torch.equal(tsim.cc_data.data, U0)      # the step is pure
    a, b = _interior(Uj, g), _interior(Ut, g)
    assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max()

    # the kernel wrapper takes the plain step for CPU tensors
    Uw = tsim._step(tsim.cc_data.data, t, dt)
    assert torch.equal(Uw, Ut)
    if case == "walls_floor_sponge":
        # the floor and the sponge have zones to act on
        assert float(_interior(U0, g)[0].min()) < 0.2


def test_dt_matches_jax():
    jsim = _jax_sim("quad", {"mesh.nx": 20, "mesh.ny": 36})
    tsim = _torch_sim(jsim)
    a = float(jsim._make_dt()(jsim.cc_data.data))
    b = float(tsim._make_dt()(tsim.cc_data.data))
    assert abs(a - b) <= 1e-14 * abs(a)


def test_quad_20_steps_match_jax():
    inputs = {"mesh.nx": 24, "mesh.ny": 32, "driver.max_steps": 20,
              "driver.tmax": 10.0}
    pj = JPyro("compressible")
    pj.initialize_problem("quad", inputs_dict=inputs)
    pt = Pyro("compressible", device="cpu")
    pt.initialize_problem("quad", inputs_dict=inputs)
    assert pt.sim.cc_data.data.dtype == torch.float64
    dts_j, dts_t = [], []
    for _ in range(20):
        pj.single_step()
        pt.single_step()
        dts_j.append(pj.sim.dt)
        dts_t.append(pt.sim.dt)
    np.testing.assert_allclose(dts_t, dts_j, rtol=1e-12, atol=0)
    g = pt.sim.cc_data.grid
    a = _interior(pj.sim.cc_data.data, g)
    b = _interior(pt.sim.cc_data.data, g)
    assert np.abs(a - b).max() <= 1e-10 * np.abs(a).max()
    assert pt.sim.n == 20


def test_f32_plain_step_matches_pallas_interpret():
    from pyro2_tpu.solvers.compressible.pallas_step import \
        make_pallas_ctu_step_padded_general

    jsim = _jax_sim("quad", {"mesh.nx": 32, "mesh.ny": 32})
    to_p, from_p, fill_p, step_p = \
        make_pallas_ctu_step_padded_general(jsim, interpret=True)
    U0 = jsim.cc_data.data.astype(jnp.float32)
    dt = np.float32(1e-3)
    t = jnp.asarray(0.0, jnp.float32)
    Pf = fill_p(to_p(U0), t)
    got = np.asarray(from_p(step_p(Pf, t, jnp.asarray(dt))))

    tsim = _torch_sim(jsim, dtype=torch.float32)
    Uf = torch.as_tensor(np.array(from_p(Pf)))
    assert Uf.dtype == torch.float32
    Ut = tsim._make_step()(Uf, 0.0, float(dt))
    g = tsim.cc_data.grid
    a, b = _interior(got, g), _interior(Ut, g)
    assert np.abs(a - b).max() <= 1e-5 * np.abs(a).max()


# -- the kernel wrapper -------------------------------------------------------

def test_kernel_wrapper_checks_inputs():
    jsim = _jax_sim("quad", {"mesh.nx": 20, "mesh.ny": 36})
    tsim = _torch_sim(jsim)
    step = tsim._step
    assert isinstance(step, ctu_kernel.CTUStep)
    U = tsim.cc_data.data
    before = ctu_kernel.launches
    out = step(U, 0.0, 1e-4)           # CPU tensor: the plain step
    assert out.shape == U.shape and ctu_kernel.launches == before
    with pytest.raises(TypeError):
        step(U.to(torch.int32), 0.0, 1e-4)
    with pytest.raises(TypeError):
        step(U.to(torch.float16), 0.0, 1e-4)
    with pytest.raises(ValueError):
        step(U[:, 1:, :].contiguous(), 0.0, 1e-4)
    with pytest.raises(ValueError):
        step(U.permute(0, 2, 1).contiguous().permute(0, 2, 1), 0.0, 1e-4)
    with pytest.raises(ValueError):
        step(torch.empty(U.shape, dtype=U.dtype, device="meta"), 0.0, 1e-4)
    with pytest.raises(ValueError):
        step.launch(U, 0.0, 1e-4)      # the CUDA kernel on a CPU tensor
    assert ctu_kernel.launches == before


SPHERICAL = {"mesh.nx": 16, "mesh.ny": 16,
             "mesh.grid_type": "SphericalPolar",
             "mesh.xmin": 0.5, "mesh.xmax": 1.0,
             "mesh.ymin": 0.7853981633974483,
             "mesh.ymax": 2.356194490192345}


def test_uncovered_configurations_raise():
    """The method-of-lines solvers run on a spherical grid (their stages
    read no interface state), through the kernels' extended
    instantiation.  A problem source that is not an energy rate rho e_rate
    w(x, y) (its module has no source_weight) initializes and steps on the
    CPU, and the CTU kernel's launch refuses it naming A.27 before it
    looks at the device, so the refusal shows without a card."""
    for solver in ("compressible_rk", "compressible_fv4", "compressible_sdc"):
        pt = Pyro(solver, device="cpu")
        # square cells (dr = dtheta), which fv4's averages need
        pt.initialize_problem("acoustic_pulse", inputs_dict={
            **SPHERICAL, "mesh.ymax": SPHERICAL["mesh.ymin"] + 0.5,
            "compressible.riemann": "CGF"})
        assert pt.sim._step.spherical and pt.sim._step.extended
    pt = Pyro("compressible", device="cpu")
    pt.initialize_problem("quad", inputs_dict={"mesh.nx": 16,
                                                "mesh.ny": 16})
    sim = tcomp.Simulation("compressible", "quad", quad.init_data, pt.rp,
                           problem_source_func=lambda *a: 0.0, device="cpu")
    sim.initialize()
    U = sim.cc_data.data
    assert sim._step(U, 0.0, 1e-4).shape == U.shape    # the plain step
    with pytest.raises(NotImplementedError,
                       match=r"problem source .*ROADMAP\.md A\.27"):
        sim._step.launch(U, 0.0, 1e-4)


@pytest.mark.parametrize("riemann,jax_error,jax_match,error,match", [
    ("HLLC", RuntimeError, "HLLC Riemann Solver is not supported",
     RuntimeError, "HLLC Riemann Solver is not supported"),
    ("HLLC_lm", ValueError, "unpack",
     ValueError, "needs compressible.riemann = CGF")])
def test_spherical_needs_cgf(riemann, jax_error, jax_match, error, match,
                             monkeypatch):
    """HLLC fails in initialize as the JAX package's msg.fail does;
    HLLC_lm has no interface state for the spherical pressure gradients
    (the JAX step fails unpacking its flux), so the port refuses it up
    front, on any device."""
    pj = JPyro("compressible")
    with pytest.raises(jax_error, match=jax_match):
        pj.initialize_problem("advect", inputs_dict={
            **SPHERICAL, "compressible.riemann": riemann})
        pj.single_step()
    for device in ("cpu", "cuda"):
        if device == "cuda":
            # the refusal comes before the device is touched
            monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        pt = Pyro("compressible", device=device)
        with pytest.raises(error, match=match):
            pt.initialize_problem("advect", inputs_dict={
                **SPHERICAL, "compressible.riemann": riemann})
