"""Parity of the PyTorch port's low-Mach atmosphere solver (lm_atm) with
pyro2_tpu, and the traps of its windows, projections and step.

The same inputs, made from a numpy seed or by each package's own problem
module, go through the JAX functions (CPU, x64, tests/conftest.py, the jnp
path: the JAX package takes its Pallas stages only on a TPU) and the port
(CPU, float64, where the lm_kernel entries run their plain versions).
Tolerances:
  * interface stages and the plain kernel entries: the same float64
    operations in the same order, so 1e-12 of each output's own scale
    (its max, at least 1);
  * Basestate and initialize: exact (the same numpy float64 code);
  * Pyro runs (preevolve's projection and throw-away step, then steps,
    three multigrid solves each with float64 roundoff at their floor): dt
    to 1e-12 relative, every state variable to 1e-10 of its max.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro2_tpu.solvers.lm_atm.LM_atm_interface as jli
import pyro2_tpu_torch.solvers.lm_atm.LM_atm_interface as tli
from pyro2_tpu import Pyro as JPyro
from pyro2_tpu.mesh.grid import Cartesian2d as JCartesian2d
from pyro2_tpu.mesh.indexer import ai as jai
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Cartesian2d, SphericalPolar
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.multigrid import MG
from pyro2_tpu_torch.multigrid import variable_coeff_MG as vcMG
from pyro2_tpu_torch.solvers.lm_atm import lm_kernel
from pyro2_tpu_torch.util.carry import carry_simulation

N = 64          # the grid of the Pyro runs (the golden's)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(ref, got, tol=1e-12):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    err = np.abs(ref - got).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


# -- fields -------------------------------------------------------------------

def _grids(nx=24, ny=16):
    return JCartesian2d(nx, ny, ng=4, xmax=1.0, ymax=ny / nx), \
        Cartesian2d(nx, ny, ng=4, xmax=1.0, ymax=ny / nx)


def _fields(kind, g, seed=7):
    """The 12 planes of the stages: u, v, the four velocity slopes, gpx,
    gpy, source, rho and its two slopes.  "signed": u > 0 and v < 0
    decisively (as tests/test_lm_pallas.py); "ties": exact zero velocities
    on rows and columns, and opposed states, so the upwind tie (s == 0)
    and every Riemann branch fire."""
    rng = np.random.default_rng(seed)

    def mk(lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, size=(g.qx, g.qy))

    u, v = mk(0.2, 1.2), mk(-1.2, -0.2)
    planes = [mk() for _ in range(7)]
    rho, lrx, lry = mk(0.5, 1.5), mk(), mk()
    if kind == "ties":
        u[::3] = 0.0
        v[:, ::2] = 0.0
        u[:, 5] = -u[:, 6]
        planes[0][1::4] = 0.0          # zero slopes: hat states at rest
        planes[3][:, 1::3] = 0.0
    return [u, v] + planes + [rho, lrx, lry]


KINDS = ["signed", "ties"]
DT = 0.01


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], \
        [torch.as_tensor(a) for a in arrays]


# -- the interface functions against JAX --------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_upwind_and_riemann_match_jax(kind):
    jg, tg = _grids()
    f = _fields(kind, tg)
    (jl, jr, js), (tl, tr, ts) = _both([f[0], f[1] + f[0], f[2]])
    if kind == "ties":
        ts = ts.clone()
        ts[::2] = 0.0
        js = jnp.asarray(ts.numpy())
    _close(jli.upwind(jg, jl, jr, js), tli.upwind(tg, tl, tr, ts))
    _close(jli.riemann(jg, jl, jr), tli.riemann(tg, tl, tr))
    _close(jli.riemann_and_upwind(jg, jl, jr),
           tli.riemann_and_upwind(tg, tl, tr))


@pytest.mark.parametrize("kind", KINDS)
def test_get_interface_states_match_jax(kind):
    jg, tg = _grids()
    jf, tf = _both(_fields(kind, tg)[:9])
    for a, b in zip(jli.get_interface_states(jg, jg.dx, jg.dy, DT, *jf),
                    tli.get_interface_states(tg, tg.dx, tg.dy, DT, *tf)):
        _close(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_mac_vels_states_and_rho_states_match_jax(kind):
    jg, tg = _grids(16, 24)
    jf, tf = _both(_fields(kind, tg))
    jm = jli.mac_vels(jg, jg.dx, jg.dy, DT, *jf[:9])
    tm = tli.mac_vels(tg, tg.dx, tg.dy, DT, *tf[:9])
    for a, b in zip(jm, tm):
        _close(a, b)
    for a, b in zip(jli.states(jg, jg.dx, jg.dy, DT, *jf[:9], *jm),
                    tli.states(tg, tg.dx, tg.dy, DT, *tf[:9], *tm)):
        _close(a, b)
    rho = jf[9:]
    for a, b in zip(
            jli.rho_states(jg, jg.dx, jg.dy, DT, rho[0], *jm, *rho[1:]),
            tli.rho_states(tg, tg.dx, tg.dy, DT, tf[9], *tm, *tf[10:])):
        _close(a, b)


# -- traps of the interface: windows and ties ---------------------------------

def _window(g, buf, ishift=0, jshift=0):
    """The boolean frame of a (xlo, xhi, ylo, yhi) window, shifted."""
    b = buf if isinstance(buf, tuple) else (buf,) * 4
    if len(b) == 2:
        b = (b[0], b[1], b[0], b[1])
    m = torch.zeros((g.qx, g.qy), dtype=torch.bool)
    m[g.ilo - b[0] + ishift:g.ihi + 1 + b[1] + ishift,
      g.jlo - b[2] + jshift:g.jhi + 1 + b[3] + jshift] = True
    return m


def test_upwind_tie_takes_the_average_and_riemann_branches():
    _, g = _grids(8, 8)
    ql = torch.zeros((g.qx, g.qy), dtype=torch.float64)
    qr = torch.zeros_like(ql)
    s = torch.zeros_like(ql)
    ql[:] = 0.75
    qr[:] = -0.25
    out = ai(tli.upwind(g, ql, qr, s), g).v()
    assert torch.all(out == 0.25)                       # 0.5 (ql + qr)
    # riemann: (ql > 0, ql + qr > 0) -> ql; (ql <= 0, qr >= 0) -> 0; else qr
    for l, r, want in ((0.5, -0.25, 0.5), (0.5, -0.75, -0.75),
                       (0.0, 0.0, 0.0), (-0.5, 0.25, 0.0),
                       (-0.5, -0.25, -0.25), (0.0, -0.5, -0.5),
                       (0.0, 0.5, 0.0)):
        ql[:], qr[:] = l, r
        assert torch.all(ai(tli.riemann(g, ql, qr), g).v() == want), (l, r)


def test_riemann_and_upwind_are_zero_outside_their_window():
    _, g = _grids()
    rng = np.random.default_rng(3)
    ql, qr, s = (torch.as_tensor(1.0 + rng.random((g.qx, g.qy)))
                 for _ in range(3))
    w12 = _window(g, (1, 2))
    for out in (tli.riemann(g, ql, qr), tli.upwind(g, ql, qr, s)):
        assert torch.all(out[~w12] == 0) and torch.all(out[w12] != 0)


def test_hat_states_sit_on_buf2_with_the_left_one_zone_up():
    _, g = _grids()
    u, v, lux, *rest = (torch.as_tensor(a) for a in _fields("signed", g)[:9])
    zero = torch.zeros_like(u)
    # no corrections reach the states when gradp, source and v vanish
    # (then vbar = 0): the hat states stand alone
    states = tli.get_interface_states(
        g, g.dx, g.dy, DT, u, zero, lux, zero, zero, zero, zero, zero, zero)
    u_xl, u_xr = states[0], states[1]
    dtdx = DT / g.dx
    hat_l = u + 0.5 * (1.0 - dtdx * u) * lux
    hat_r = u - 0.5 * (1.0 + dtdx * u) * lux
    w2 = _window(g, 2)
    # left states: predicted from cell i, stored at i + 1
    up = _window(g, 2, ishift=1)
    assert torch.equal(u_xl[up], hat_l[w2]) and not u_xl[~up].any()
    assert torch.equal(u_xr[w2], hat_r[w2]) and not u_xr[~w2].any()


def test_corrections_reach_both_states_on_buf1():
    _, g = _grids()
    f = [torch.as_tensor(a) for a in _fields("signed", g)[:9]]
    zero = torch.zeros_like(f[0])
    base = tli.get_interface_states(g, g.dx, g.dy, DT, *f[:6], zero, zero,
                                    zero)
    gpx = torch.ones_like(zero)         # du_x = du_y -= 0.5 dt everywhere
    corr = tli.get_interface_states(g, g.dx, g.dy, DT, *f[:6], gpx, zero,
                                    zero)
    d_xl, d_xr = corr[0] - base[0], corr[1] - base[1]
    # the correction lands on the buf=1 window, the left state's shifted
    # up one zone, the right state's in place
    assert torch.allclose(d_xl[_window(g, 1, ishift=1)],
                          torch.tensor(-0.5 * DT, dtype=torch.float64))
    assert not d_xl[~_window(g, 1, ishift=1)].any()
    assert torch.allclose(d_xr[_window(g, 1)],
                          torch.tensor(-0.5 * DT, dtype=torch.float64))
    assert not d_xr[~_window(g, 1)].any()


def test_rho_states_correct_on_buf2_then_upwind_again():
    jg, tg = _grids()
    f = _fields("signed", tg)
    t = [torch.as_tensor(a) for a in f]
    um, vm = tli.mac_vels(tg, tg.dx, tg.dy, DT, *t[:9])
    rxi, ryi = tli.rho_states(tg, tg.dx, tg.dy, DT, t[9], um, vm, t[10],
                              t[11])
    # the second upwind keeps the (lo-1, hi+2) window, zeros outside
    w12 = _window(tg, (1, 2))
    assert not rxi[~w12].any() and not ryi[~w12].any()
    # the buf=2 corrections reach the window's first row (lo-1), which a
    # buf=1 correction would leave at the first-pass value
    jm = jli.mac_vels(jg, jg.dx, jg.dy, DT, *map(jnp.asarray, f[:9]))
    jrx, _ = jli.rho_states(jg, jg.dx, jg.dy, DT, jnp.asarray(f[9]), *jm,
                            jnp.asarray(f[10]), jnp.asarray(f[11]))
    row = tg.ilo - 1
    _close(np.asarray(jrx)[row], rxi[row])
    first = tli.upwind(tg, *_rho_hats(tg, t[9], um, vm, t[10]), um)
    assert not torch.equal(rxi[row, tg.jlo:tg.jhi], first[row, tg.jlo:tg.jhi])


def _rho_hats(g, rho, um, vm, lrx):
    r = ai(rho, g).v(buf=2)
    dtdx = DT / g.dx
    xl = tli._put(g, r + 0.5 * (1.0 - dtdx * ai(um, g).ip(1, buf=2)) *
                  ai(lrx, g).v(buf=2), 2, 2, ishift=1)
    xr = tli._put(g, r - 0.5 * (1.0 + dtdx * ai(um, g).v(buf=2)) *
                  ai(lrx, g).v(buf=2), 2, 2)
    return xl, xr


# -- the lm_kernel entries (their plain versions on the CPU) ------------------

@pytest.mark.parametrize("kind", KINDS)
def test_kernel_entries_match_the_jnp_path(kind):
    jg, tg = _grids(24, 32)
    f = _fields(kind, tg, seed=11)
    jf, tf = _both(f)
    lm = lm_kernel.LMInterface(tg)
    jm = jli.mac_vels(jg, jg.dx, jg.dy, DT, *jf[:9])
    tm = lm.mac_vels(DT, *tf[:9])
    for a, b in zip(jm, tm):
        _close(a, b)
    # the jnp expressions of pyro2_tpu/solvers/lm_atm/simulation.py
    rxi, ryi = (jai(a, jg) for a in jli.rho_states(
        jg, jg.dx, jg.dy, DT, jf[9], *jm, *jf[10:]))
    um, vm = jai(jm[0], jg), jai(jm[1], jg)
    inc = -DT * ((rxi.ip(1) * um.ip(1) - rxi.v() * um.v()) / jg.dx +
                 (ryi.jp(1) * vm.jp(1) - ryi.v() * vm.v()) / jg.dy)
    _close(inc, lm.rho_increment(DT, tf[9], *tm, *tf[10:]))
    uxi, vxi, uyi, vyi = (jai(a, jg) for a in jli.states(
        jg, jg.dx, jg.dy, DT, *jf[:9], *jm))
    ax = (0.5 * (um.v() + um.ip(1)) * (uxi.ip(1) - uxi.v()) / jg.dx +
          0.5 * (vm.v() + vm.jp(1)) * (uyi.jp(1) - uyi.v()) / jg.dy)
    ay = (0.5 * (um.v() + um.ip(1)) * (vxi.ip(1) - vxi.v()) / jg.dx +
          0.5 * (vm.v() + vm.jp(1)) * (vyi.jp(1) - vyi.v()) / jg.dy)
    tax, tay = lm.advect_terms(DT, *tf[:9], *tm)
    assert tax.shape == (tg.nx, tg.ny)
    _close(ax, tax)
    _close(ay, tay)


def test_cpu_entries_count_nothing_and_launches_raise():
    _, g = _grids()
    t = [torch.as_tensor(a) for a in _fields("signed", g)]
    lm = lm_kernel.LMInterface(g)
    before = dict(lm_kernel.launches)
    um, vm = lm.mac_vels(DT, *t[:9])
    lm.rho_increment(DT, t[9], um, vm, t[10], t[11])
    lm.advect_terms(DT, *t[:9], um, vm)
    for launch, planes in ((lm.launch_mac, t[:9]),
                           (lm.launch_rho, (t[9], um, vm, t[10], t[11])),
                           (lm.launch_states, t[:9] + [um, vm])):
        with pytest.raises(ValueError, match="CUDA"):
            launch(DT, *planes)
    assert lm_kernel.launches == before


def test_entries_check_what_they_are_given():
    _, g = _grids()
    lm = lm_kernel.LMInterface(g)
    t = [torch.as_tensor(a) for a in _fields("signed", g)[:9]]
    with pytest.raises(ValueError, match="frame"):
        lm.mac_vels(DT, *t[:8], t[8][1:])
    with pytest.raises(ValueError, match="one device and dtype"):
        lm.mac_vels(DT, *t[:8], t[8].float())
    with pytest.raises(NotImplementedError, match="A.11"):
        lm_kernel.LMInterface(Cartesian2d(16, 16, ng=2))
    with pytest.raises(NotImplementedError, match="A.11"):
        lm_kernel.LMInterface(SphericalPolar(16, 16, ng=4, xmin=0.5))


def test_work_counts_planes_and_operations():
    frame, inner = 1032 * 1032, 1024 * 1024
    b, ops = lm_kernel.work("lm_mac", 1024, 1024, torch.float32)
    assert b == 11 * frame * 4 and ops == 100 * 1027 * 1027
    b, _ = lm_kernel.work("lm_rho", 1024, 1024, torch.float32)
    assert b == (5 * frame + inner) * 4
    b, ops = lm_kernel.work("lm_states", 1024, 1024, torch.float64)
    assert b == (11 * frame + 2 * inner) * 8
    faces = 1025 * 1024 * 2          # the x and y faces, each once
    assert ops == 42 * 1027 * 1027 + 56 * faces + 18 * inner
    with pytest.raises(ValueError):
        lm_kernel.work("lm_other", 8, 8, torch.float32)


# -- the Simulation -----------------------------------------------------------

def _inputs(**extra):
    return {"mesh.nx": N, "mesh.ny": N, **extra}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's bubble at 64^2 after preevolve, and the states
    and dts of its first five steps."""
    pj = JPyro("lm_atm")
    pj.initialize_problem("bubble", inputs_dict=_inputs())
    states = [np.asarray(pj.sim.cc_data.data)]
    dts = []
    for _ in range(5):
        pj.single_step()
        states.append(np.asarray(pj.sim.cc_data.data))
        dts.append(pj.sim.dt)
    return pj, states, dts


def _assert_state(ref, sim, tol=1e-10):
    got = sim.cc_data.data.numpy()
    for n, name in enumerate(sim.cc_data.names):
        scale = max(np.abs(ref[n]).max(), 1e-300)
        assert np.abs(ref[n] - got[n]).max() <= tol * scale, name


def test_basestate_and_initialize_match_jax():
    from pyro2_tpu.solvers import lm_atm as jlm
    from pyro2_tpu_torch.solvers import lm_atm as tlm

    pj = JPyro("lm_atm")
    pj.initialize_problem("bubble", inputs_dict=_inputs())
    jmod = importlib.import_module("pyro2_tpu.solvers.lm_atm.problems.bubble")
    tmod = importlib.import_module(
        "pyro2_tpu_torch.solvers.lm_atm.problems.bubble")
    jsim = jlm.Simulation("lm_atm", "bubble", jmod.init_data, pj.rp)
    jsim.initialize()
    sim = tlm.Simulation("lm_atm", "bubble", tmod.init_data, pj.rp,
                         device="cpu")
    sim.initialize()
    assert sim.cc_data.names == jsim.cc_data.names
    assert np.array_equal(sim.cc_data.data.numpy(),
                          np.asarray(jsim.cc_data.data))
    for name, b in jsim.base.items():
        assert sim.base[name].d.dtype == np.float64
        assert np.array_equal(sim.base[name].d, b.d), name
    # make_prime subtracts the (1, qy) profile along y, from every column
    rho = sim.cc_data.get_var("density")
    prime = sim.make_prime(rho, sim.base["rho0"])
    assert torch.equal(prime[3], rho[3] - torch.as_tensor(
        sim.base["rho0"].d))
    _close(jsim.make_prime(jsim.cc_data.get_var("density"),
                           jsim.base["rho0"]), prime)


def test_beta0_edges_take_the_end_values_of_beta0():
    pt = Pyro("lm_atm", device="cpu")
    pt.initialize_problem("bubble", inputs_dict=_inputs(**{
        "mesh.nx": 16, "mesh.ny": 16}))
    g = pt.get_grid()
    b0, be = pt.sim.base["beta0"].d, pt.sim.base["beta0-edges"].d
    assert be[g.jlo] == b0[g.jlo] and be[g.jhi + 1] == b0[g.jhi]
    mid = 0.5 * (b0[g.jlo:g.jhi] + b0[g.jlo + 1:g.jhi + 1])
    assert np.array_equal(be[g.jlo + 1:g.jhi + 1], mid)


def test_preevolve_one_step_and_five_steps_match_jax(jax_run):
    pj, states, dts = jax_run
    pt = Pyro("lm_atm", device="cpu")
    pt.initialize_problem("bubble", inputs_dict=_inputs())
    assert pt.sim.n == 0 and pt.sim.cc_data.t == 0.0
    _assert_state(states[0], pt.sim)
    assert float(pt.sim.cc_data.get_var("gradp_y").abs().max()) > 0.0
    for k in range(5):
        pt.single_step()
        assert abs(pt.sim.dt - dts[k]) <= 1e-12 * dts[k]
        _assert_state(states[k + 1], pt.sim)
    assert pt.sim.n == 5
    assert abs(pt.sim.cc_data.t - pj.sim.cc_data.t) <= 1e-12


def test_a_carried_mid_run_state_steps_as_jax_does(jax_run):
    pj, _, _ = jax_run
    jsim = pj.sim
    base = {name: b.d.copy() for name, b in jsim.base.items()}
    sim = carry_simulation("lm_atm", "bubble", jsim.rp.params,
                           np.asarray(jsim.cc_data.data),
                           t=jsim.cc_data.t, n=jsim.n, base=base,
                           device="cpu")
    for name in base:
        assert np.array_equal(sim.base[name].d, base[name])
    sim.dt_old = jsim.dt_old        # the time loop's history, not state
    for s in (jsim, sim):
        s.cc_data.fill_BC_all()
        s.compute_timestep()
        s.evolve()
    assert abs(sim.dt - jsim.dt) <= 1e-12 * jsim.dt
    _assert_state(np.asarray(jsim.cc_data.data), sim)
    with pytest.raises(ValueError, match="base state"):
        carry_simulation("lm_atm", "bubble", jsim.rp.params,
                         np.asarray(jsim.cc_data.data),
                         base={"rho0": np.zeros(5)}, device="cpu")


def test_proj_type_1_matches_jax(jax_run):
    inputs = _inputs(**{"lm-atmosphere.proj_type": 1})
    pj = JPyro("lm_atm")
    pj.initialize_problem("bubble", inputs_dict=inputs)
    pt = Pyro("lm_atm", device="cpu")
    pt.initialize_problem("bubble", inputs_dict=inputs)
    for _ in range(2):
        pj.single_step()
        pt.single_step()
    _assert_state(np.asarray(pj.sim.cc_data.data), pt.sim)


def _small(**extra):
    pt = Pyro("lm_atm", device="cpu")
    pt.initialize_problem("bubble", inputs_dict={
        "mesh.nx": 16, "mesh.ny": 16, **extra})
    return pt


def test_preevolve_keeps_t_and_n_and_needs_a_copying_clone(monkeypatch):
    pt = _small()
    assert pt.sim.n == 0 and pt.sim.cc_data.t == 0.0
    assert not pt.sim.in_preevolve
    # preevolve restores the projected velocities (the throw-away step
    # moved them); with a clone that shares the state tensor, the step
    # leaks into the restored state
    copying_clone = patch.cell_center_data_clone

    def sharing_clone(old):
        new = copying_clone(old)
        new.data = old.data
        return new

    monkeypatch.setattr(patch, "cell_center_data_clone", sharing_clone)
    leaked = _small().sim.cc_data.get_var("density").clone()
    monkeypatch.undo()
    assert not torch.equal(leaked, pt.sim.cc_data.get_var("density"))


def test_timestep_tests_motion_everywhere_and_takes_cfl_inside():
    pt = _small()
    sim, g = pt.sim, pt.get_grid()
    u = sim.cc_data.get_var("x-velocity")
    v = sim.cc_data.get_var("y-velocity")
    u.zero_()
    v.zero_()
    v[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = 0.02
    v[0, 0] = 50.0                      # a ghost: read by the motion test
    rho = sim.cc_data.get_var("density")    # only, not by the CFL
    rho[0, 0] = 1e-3                    # nor by the buoyancy dt
    sim.method_compute_timestep()
    prime = sim.make_prime(rho, sim.base["rho0"])
    f_buoy = float((ai(prime * sim.rp.get_param("lm-atmosphere.grav"),
                       g).v().abs() / ai(rho, g).v()).max())
    cfl = sim.rp.get_param("driver.cfl")
    assert sim.dt == min(cfl * g.dy / 0.02, np.sqrt(2.0 * g.dx / f_buoy))
    # moving ghosts around a fluid at rest inside: as in the JAX package,
    # the CFL divides by the interior maximum, zero
    u[0, 0] = 1.0
    with pytest.raises(ZeroDivisionError):
        sim.method_compute_timestep()


def test_projections_solve_from_the_right_guess_at_the_right_rtol(
        monkeypatch):
    calls = []
    solve = vcMG.VarCoeffCCMG2d.solve

    def recording(self, rtol=1.e-11):
        calls.append((rtol, self.v[-1].clone(), self))
        return solve(self, rtol=rtol)

    monkeypatch.setattr(vcMG.VarCoeffCCMG2d, "solve", recording)
    pt = _small()
    assert [c[0] for c in calls] == [1e-10, 1e-12, 1e-12]   # preevolve
    pt.single_step()            # the bubble starts at rest: phi is 0 so far
    calls.clear()
    sim, g = pt.sim, pt.get_grid()
    phi = sim.cc_data.get_var("phi").clone()
    assert phi.abs().max() > 0
    rho = sim.cc_data.get_var("density").clone()
    pt.single_step()
    (rtol_mac, guess_mac, mg_mac), (rtol_fin, guess_fin, _) = calls
    assert rtol_mac == rtol_fin == 1e-12
    assert not guess_mac.any()                  # the MAC solve: from zero
    # the final solve starts from the previous phi on buf=1
    assert torch.equal(ai(guess_fin, mg_mac.soln_grid).v(buf=1),
                       ai(phi, g).v(buf=1))
    # the coefficient: (1 / rho) beta0^2 from the ng=4 grid
    beta0 = torch.as_tensor(sim.base["beta0"].d)
    want = (1.0 / rho) * beta0[None, :] ** 2
    assert torch.equal(ai(mg_mac.aux["coeffs"][-1], mg_mac.soln_grid).v(),
                       ai(want, g).v())


def test_cc_div_beta_U_lands_on_the_mg_grid():
    pt = _small()
    sim, g = pt.sim, pt.get_grid()
    mg = sim._vc_mg("phi", sim.cc_data.get_var("density"))
    rng = np.random.default_rng(2)
    u, v = (torch.as_tensor(rng.random((g.qx, g.qy))) for _ in range(2))
    out = sim._cc_div_beta_U(u, v, sim.base["beta0"], mg.soln_grid)
    sg = mg.soln_grid
    assert out.shape == (sg.qx, sg.qy) and sg.ng == 1
    assert not out[0].any() and not out[:, -1].any()
    assert ai(out, sg).v().abs().min() > 0


class _Recorder:
    def __init__(self, lm):
        self.lm, self.calls = lm, {}

    def mac_vels(self, dt, *a):
        out = self.lm.mac_vels(dt, *a)
        self.calls["mac"] = [o.clone() for o in out]
        return out

    def rho_increment(self, dt, *a):
        self.calls["rho"] = a
        return self.lm.rho_increment(dt, *a)

    def advect_terms(self, dt, *a):
        self.calls["states"] = a
        return self.lm.advect_terms(dt, *a)


def test_mac_corrections_cover_the_high_faces_only():
    pt = _small()
    sim, g = pt.sim, pt.get_grid()
    rec = _Recorder(sim.lm)
    sim.lm = rec
    pt.single_step()
    raw_u, raw_v = rec.calls["mac"]
    um, vm = rec.calls["rho"][1:3]
    assert um is rec.calls["states"][9]
    du, dv = (um - raw_u) != 0, (vm - raw_v) != 0
    bx = _window(g, (0, 1, 0, 0))
    by = _window(g, (0, 0, 0, 1))
    assert du[bx].sum() > 0.9 * bx.sum() and not du[~bx].any()
    assert dv[by].sum() > 0.9 * by.sum() and not dv[~by].any()
    # the high faces: periodic in x, Dirichlet phi at the top
    assert du[g.ihi + 1, g.jlo:g.jhi + 1].all()
    assert dv[g.ilo:g.ihi + 1, g.jhi + 1].all()


def test_coeff_is_filled_with_the_density_bcs():
    pt = _small()
    sim, g = pt.sim, pt.get_grid()
    assert sim.aux_data.BCs["coeff"] is sim.cc_data.BCs["density"]
    assert sim.cc_data.BCs["phi"].ylb == "neumann"
    assert sim.cc_data.BCs["phi"].yrb == "dirichlet"
    pt.single_step()
    c = sim.aux_data.get_var("coeff")
    # reflect (even) at the bottom, outflow at the top, periodic in x
    assert torch.equal(c[:, g.jlo - 1], c[:, g.jlo])
    assert torch.equal(c[:, g.jhi + 1], c[:, g.jhi])
    assert torch.equal(c[g.ilo - 1], c[g.ihi])


def test_two_solves_a_step_three_in_preevolve():
    before = dict(MG.stats)
    pt = _small()
    assert MG.stats["solves"] == before["solves"] + 3
    pt.single_step()
    assert MG.stats["solves"] == before["solves"] + 5


def test_dovis_is_not_ported():
    """dovis is ported (it refused before): it draws rho', the two
    velocities and the vorticity into figure 1, the velocities' images
    the interiors of the state (tests/test_torch_plot.py holds every
    image to the JAX package's)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pt = _small()
    g = pt.sim.cc_data.grid
    plt.figure(num=1, clear=True)
    try:
        pt.sim.dovis()
        axes = [ax for ax in plt.figure(1).axes if ax.get_images()]
        titles = [ax.get_title() for ax in axes]
        images = [np.asarray(ax.get_images()[0].get_array()) for ax in axes]
    finally:
        plt.close("all")
    assert titles == [r"$\rho'$", "x-velocity", "y-velocity", "vorticity"]
    for name, image in zip(("x-velocity", "y-velocity"), images[1:3]):
        u = pt.sim.cc_data.get_var(name)[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]
        assert np.array_equal(image, u.numpy().T)
