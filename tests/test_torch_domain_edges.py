"""The domain-edge flags of the port's compressible CTU step, and the
no-fill scalar steps, which the sharded tier runs on each block, held
against pyro2_tpu on the CPU in float64.

* The plain step with `DomainEdges` flags against the JAX package's
  `_make_step` with the same flags, on one frame (quad, or advect on a
  spherical grid, with the velocities perturbed from a numpy seed so that
  every face sees compression): max|diff| <= 1e-12 max|U| on the
  interior.  The JAX step runs eagerly: on this frame XLA's jitted quad
  step differs from its own eager operations by 9e-3 in a few cells (the
  fused write-back that pyro2_tpu/solvers/advection/simulation.py's
  `_build_step` notes), which the port matches to 1e-16.
* A seam flag (0) changes the update of the cells beside that high edge
  alone: a step that left a seam face without its viscosity would equal
  the all-1 step.
* The default flags keep the serial step's bits: the viscosity against
  the formula of the port before the flags, the kernel's ints carry the
  flags.
* The no-fill advection and burgers steps against the JAX package's
  `_build_step(fill_ghosts=False)` on frames with arbitrary ghosts (rtol
  1e-12; burgers eagerly, as tests/test_torch_burgers.py runs it), and the
  default steps equal to a fill and the no-fill step, bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.mesh.indexer import ai, embed, fill_ghost
from pyro2_tpu_torch.solvers.compressible import interface as tifc
from pyro2_tpu_torch.solvers.compressible import simulation as tcomp
from pyro2_tpu_torch.solvers.compressible.problems import advect, quad
from pyro2_tpu_torch.util.carry import carry

SPH = {"mesh.grid_type": "SphericalPolar", "mesh.xmin": 0.5,
       "mesh.xmax": 1.0, "mesh.ymin": 0.7853981633974483,
       "mesh.ymax": 2.356194490192345, "compressible.riemann": "CGF"}
FRAMES = {"quad": ("quad", quad, {"mesh.nx": 24, "mesh.ny": 20}),
          "spherical": ("advect", advect,
                        {"mesh.nx": 24, "mesh.ny": 20, **SPH})}


def _sims(frame):
    """(JAX sim, port sim) on the same perturbed, ghost-filled frame."""
    problem, module, inputs = FRAMES[frame]
    p = JPyro("compressible")
    p.initialize_problem(problem, inputs_dict=inputs)
    jsim = p.sim
    jsim.cc_data.t = 0.0
    jsim.cc_data.fill_BC_all()
    U = np.array(jsim.cc_data.data)
    rng = np.random.default_rng(18)
    # new momenta, the same internal energy
    rho_e = U[1] - 0.5 * (U[2] ** 2 + U[3] ** 2) / U[0]
    for n in (2, 3):
        U[n] = U[n] * (1.0 + 0.5 * rng.standard_normal(U[n].shape)) + \
            0.2 * rng.standard_normal(U[n].shape) * U[0]
    U[1] = rho_e + 0.5 * (U[2] ** 2 + U[3] ** 2) / U[0]
    jsim.cc_data.data = jax.numpy.asarray(U)
    rp, tU = carry(jsim.rp.params, U, device="cpu")
    tsim = tcomp.Simulation("compressible", problem, module.init_data, rp,
                            device="cpu")
    tsim.initialize()
    tsim.cc_data.set_vars(tU)
    return jsim, tsim


def _interior(U, g):
    U = U.numpy() if isinstance(U, torch.Tensor) else np.asarray(U)
    return U[:, g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]


@pytest.mark.parametrize("frame,edges", [
    ("quad", (1, 1, 1, 1)), ("quad", (1, 0, 1, 0)), ("quad", (0, 0, 0, 0)),
    ("spherical", (1, 0, 1, 0)), ("spherical", (0, 1, 0, 1))])
def test_plain_step_edges_match_jax(frame, edges):
    jsim, tsim = _sims(frame)
    je = jsim.domain_edges
    je.xl, je.xr, je.yl, je.yr = edges
    tsim.domain_edges = tcomp.DomainEdges(*edges)
    dt = 1e-3
    with jax.disable_jit():
        Uj = jsim._make_step()(jsim.cc_data.data, 0.0, dt)
    Ut = tsim._make_step()(tsim.cc_data.data, 0.0, dt)
    g = tsim.cc_data.grid
    a, b = _interior(Uj, g), _interior(Ut, g)
    assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max()


@pytest.mark.parametrize("frame", list(FRAMES))
def test_seam_flags_act_on_the_high_faces_alone(frame):
    """xr = yr = 0 change the cells beside the high edges (the faces ihi+1
    and jhi+1 take viscosity) and no other; the low flags change
    nothing the update reads."""
    _, tsim = _sims(frame)
    U = tsim.cc_data.data
    g = tsim.cc_data.grid

    def step(edges):
        tsim.domain_edges = tcomp.DomainEdges(*edges)
        return _interior(tsim._make_step()(U, 0.0, 1e-3), g)

    serial = step((1, 1, 1, 1))
    seams = step((1, 0, 1, 0))
    diff = serial != seams
    assert diff[:, -1, :].any() and diff[:, :, -1].any()
    assert not diff[:, :-1, :-1].any()
    np.testing.assert_array_equal(step((0, 1, 0, 1)), serial)


def _avisc_before_flags(g, cvisc, u, v):
    """The port's artificial viscosity before the edge flags (the serial
    formula), Cartesian and spherical."""
    uv, vv = ai(u, g), ai(v, g)
    b = 1
    ur = 0.5 * (uv.v(buf=b) + uv.jp(-1, buf=b))
    ul = 0.5 * (uv.ip(-1, buf=b) + uv.ip_jp(-1, -1, buf=b))
    vt = 0.5 * (vv.v(buf=b) + vv.ip(-1, buf=b))
    vb = 0.5 * (vv.jp(-1, buf=b) + vv.ip_jp(-1, -1, buf=b))
    if getattr(g, "coord_type", 0) == 1:
        rc, rr, rl, sinc, sint, sinb = (
            ai(p, g).v(buf=b) for p in tifc.sph_planes(g, u))
        ux = (ur * rr ** 2 - ul * rl ** 2) / (rc ** 2 * g.dx)
        vy_raw = (sint * vt - sinb * vb) / (
            rc * torch.where(sinc == 0.0, 1.0, sinc) * g.dy)
        divU_w = ux + torch.where(sinc == 0.0, 0.0, vy_raw)
        Lx = ai(g.tensor("Lx", u), g).v()
        Ly = ai(g.tensor("Ly", u), g).v()
    else:
        divU_w = (ur - ul) / g.dx + (vt - vb) / g.dy
        Lx, Ly = g.dx, g.dy
    dv = ai(embed(divU_w, g, b), g)
    divU_x = 0.5 * (dv.v() + dv.jp(1))
    divU_y = 0.5 * (dv.v() + dv.ip(1))
    return (embed(cvisc * (-divU_x * Lx).clamp_min(0.0), g, 0),
            embed(cvisc * (-divU_y * Ly).clamp_min(0.0), g, 0))


@pytest.mark.parametrize("frame", list(FRAMES))
def test_default_edges_keep_the_serial_bits(frame):
    _, tsim = _sims(frame)
    U = tsim.cc_data.data
    g = tsim.cc_data.grid
    u, v = U[2] / U[0], U[3] / U[0]
    want = _avisc_before_flags(g, 0.1, u, v)
    for got in (tifc.artificial_viscosity(g, 0.1, u, v),
                tifc.artificial_viscosity(g, 0.1, u, v, edges=(1,) * 4)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert tsim.domain_edges.flags() == (1, 1, 1, 1)
    ints, _, _ = tsim._step.kernel_args(U, 0.0, 1e-3)
    assert len(ints) == 24 and ints[20:24] == [1, 1, 1, 1]
    tsim.domain_edges = tcomp.DomainEdges(1, 0, 1, 0)
    ints, _, _ = tsim._make_kernel_step().kernel_args(U, 0.0, 1e-3)
    assert ints[20:24] == [1, 0, 1, 0]


def _scalar_sims(solver, problem):
    inputs = {"mesh.nx": 16, "mesh.ny": 12}
    jp = JPyro(solver)
    jp.initialize_problem(problem, inputs_dict=inputs)
    tp = Pyro(solver, device="cpu")
    tp.initialize_problem(problem, inputs_dict=inputs)
    return jp.sim, tp.sim


@pytest.mark.parametrize("solver,problem", [("advection", "smooth"),
                                            ("burgers", "tophat")])
def test_no_fill_steps_match_jax(solver, problem):
    jsim, tsim = _scalar_sims(solver, problem)
    g = tsim.cc_data.grid
    rng = np.random.default_rng(7)
    # interiors of the problem, ghosts of their own
    frames = [np.array(p) for p in tsim.cc_data.data]
    ghost = np.ones((g.qx, g.qy), bool)
    ghost[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = False
    for f in frames:
        f[ghost] = rng.random(ghost.sum()) + 0.5
    dt = 1e-3
    if solver == "advection":
        got = [tsim._build_step(fill_ghosts=False)(
            torch.as_tensor(frames[0]), dt)]
        want = [jsim._build_step(fill_ghosts=False)(frames[0], dt)]
    else:
        got = tsim._make_step(fill_ghosts=False)(
            *(torch.as_tensor(f) for f in frames), dt)
        with jax.disable_jit():
            want = jsim._build_step(fill_ghosts=False)(
                *(jax.numpy.asarray(f) for f in frames), dt)
    for a, b, f in zip(want, got, frames):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max())
        # the ghosts are the frame's, untouched
        np.testing.assert_array_equal(b.numpy()[ghost], f[ghost])


@pytest.mark.parametrize("solver,problem", [("advection", "smooth"),
                                            ("burgers", "tophat")])
def test_default_step_is_fill_then_no_fill(solver, problem):
    _, tsim = _scalar_sims(solver, problem)
    g = tsim.cc_data.grid
    d = tsim.cc_data
    planes = [d.data[n].clone() for n in range(len(d.names))]
    filled = [fill_ghost(p.clone(), g, d.BCs[name])
              for p, name in zip(planes, d.names)]
    dt = 1e-3
    if solver == "advection":
        got = [tsim._build_step()(planes[0], dt)]
        want = [tsim._build_step(fill_ghosts=False)(filled[0], dt)]
    else:
        got = tsim._make_step()(*planes, dt)
        want = tsim._make_step(fill_ghosts=False)(*filled, dt)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
