"""The compressible problems with source terms (heating, convection,
plume) in the port, held to pyro2_tpu, and the repairs that let them run.

The same inputs go through the JAX package (CPU, float64: its jnp step,
which is what JAX runs on the CPU) and the port (device="cpu", float64):
  * init_data equal bit for bit, through Pyro with each problem's inputs
    file;
  * 3 steps of the CTU solver and of compressible_rk, compressible_fv4 and
    compressible_sdc, every variable's interior at rtol 1e-12 with atol
    1e-12 of the largest value of the state, every value finite, on grids
    cut to 16 columns with the published aspect ratios (fv4 needs square
    cells).  On such coarse grids fv4 and sdc convection go NaN in both
    packages from the atmosphere's top at y = 7, where the density drops
    to its cutoff (a negative density on a y face reaches CGF's sound
    speed): the 3-step parity runs them on the published domain's lower
    half, [0, 4] x [0, 6], at the same 0.25 cells, and a test of its own
    holds the NaN cells of the whole domain (32 x 96, one step) to
    coincide, every finite value to agree, and at least 40% of the cells
    to be finite;
  * source_weight against source_terms bit for bit, and source_terms
    against the JAX package's;
  * the repairs: the MOL solvers find their inputs files (the JAX
    package's, byte for byte), and carry_simulation passes the problem's
    source terms on.
"""

import filecmp
import pathlib

import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.util.carry import carry_simulation

ROOT = pathlib.Path(__file__).resolve().parent.parent
OPTS = {"driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0,
        "driver.max_steps": 3, "driver.tmax": 1.0e30, "mesh.nx": 16}
# the published domains' aspect ratios at 16 columns: heating 1 x 1,
# convection 4 x 12, plume 4 x 8
GRIDS = {"heating": {"mesh.ny": 16}, "convection": {"mesh.ny": 48},
         "plume": {"mesh.ny": 32}}
SOURCE_PROBLEMS = ("heating", "convection", "plume")
# the inputs files the MOL solvers' problem directories lacked
MOL_INPUTS = ("bubble", "convection", "gresho", "heating", "hse", "logo",
              "plume", "ramp", "rt2", "rt_multimode", "sedov")


def _pair(solver, problem, extra=None):
    inputs = {**OPTS, **GRIDS.get(problem, {}), **(extra or {})}
    pj = JPyro(solver)
    pj.initialize_problem(problem, inputs_dict=inputs)
    pt = Pyro(solver, device="cpu")
    pt.initialize_problem(problem, inputs_dict=inputs)
    return pj, pt


def _assert_steps_match(pj, pt, steps=3, nan_ok=False):
    """`steps` steps in both packages, then the interiors to rtol 1e-12
    (atol 1e-12 max|U|); with nan_ok the NaN cells must coincide."""
    for _ in range(steps):
        pj.single_step()
        pt.single_step()
    assert pt.sim.n == pj.sim.n == steps
    assert pt.sim.cc_data.t == pytest.approx(pj.sim.cc_data.t, rel=1e-12)
    g = pt.get_grid()
    sl = (slice(None), slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
    a = np.asarray(pj.sim.cc_data.data)[sl]
    b = pt.sim.cc_data.data[sl].numpy()
    if not nan_ok:
        assert np.isfinite(a).all()
    for n, name in enumerate(pt.sim.cc_data.names):
        np.testing.assert_allclose(b[n], a[n], rtol=1e-12,
                                   atol=1e-12 * np.nanmax(np.abs(a)),
                                   equal_nan=nan_ok, err_msg=name)


@pytest.mark.parametrize("problem", SOURCE_PROBLEMS)
def test_init_data_equal_by_bits(problem):
    """init_data with the problem's inputs file, every variable equal to
    the JAX package's bit for bit (convection's velocity noise is numpy's
    default_rng(12345), drawn in the same order), and the ambient state
    convection's top BC reads."""
    pj, pt = _pair("compressible", problem)
    names = pj.sim.cc_data.names
    assert pt.sim.cc_data.names == names
    for name in names:
        assert np.array_equal(pt.get_var(name).numpy(),
                              np.asarray(pj.get_var(name))), name
    for key in ("ambient_rho", "ambient_u", "ambient_v", "ambient_p"):
        assert pt.sim.cc_data.get_aux(key) == pj.sim.cc_data.get_aux(key)


@pytest.mark.parametrize("problem", SOURCE_PROBLEMS)
def test_ctu_steps_match_jax(problem):
    pj, pt = _pair("compressible", problem)
    assert pt.sim.problem_source is not None
    _assert_steps_match(pj, pt)


# convection's lower half, below the atmosphere's top (see above)
LOWER_HALF = {"mesh.ny": 24, "mesh.ymax": 6.0}


@pytest.mark.parametrize("solver", ["compressible_rk", "compressible_fv4",
                                    "compressible_sdc"])
@pytest.mark.parametrize("problem", ["heating", "convection"])
def test_mol_steps_match_jax(solver, problem):
    lower = problem == "convection" and solver != "compressible_rk"
    pj, pt = _pair(solver, problem, LOWER_HALF if lower else None)
    _assert_steps_match(pj, pt)


@pytest.mark.parametrize("solver", ["compressible_fv4", "compressible_sdc"])
def test_mol_convection_nan_cells_match_jax(solver):
    """The whole published domain at 32 x 96: after one step both packages
    have NaN in the same cells (from the atmosphere's top down), at least
    40% of the cells are finite, and every finite value agrees."""
    pj, pt = _pair(solver, "convection", {"mesh.nx": 32, "mesh.ny": 96})
    _assert_steps_match(pj, pt, steps=1, nan_ok=True)
    g = pt.get_grid()
    a = np.asarray(pj.sim.cc_data.data)[:, g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]
    finite = np.isfinite(a).all(axis=0)
    assert not finite.all()
    assert finite.mean() >= 0.4, f"finite share {finite.mean():.3f}"


@pytest.mark.parametrize("problem", SOURCE_PROBLEMS)
def test_source_weight_gives_source_terms(problem):
    """source_terms is energy_source of source_weight: zero but for the
    energy row, (rho * e_rate) * w with w rounded once to the state's
    dtype, and equal to the JAX package's source_terms bit for bit; the
    weight plane is made once per dtype and device."""
    import importlib

    from pyro2_tpu_torch.solvers.compressible.simulation import weight_plane

    pj, pt = _pair("compressible", problem)
    mod = importlib.import_module(
        f"pyro2_tpu_torch.solvers.compressible.problems.{problem}")
    jmod = importlib.import_module(
        f"pyro2_tpu.solvers.compressible.problems.{problem}")
    sim, ivars, rp = pt.sim, pt.sim.ivars, pt.sim.rp
    myg = sim.cc_data.grid
    assert sim.problem_source_weight is mod.source_weight
    U = sim.cc_data.data
    S = mod.source_terms(myg, U, ivars, rp)
    e_rate, w = mod.source_weight(myg, rp)
    assert e_rate == rp.get_param(f"{problem}.e_rate")
    expect = torch.zeros_like(U)
    expect[ivars.iener] = U[ivars.idens] * e_rate * torch.as_tensor(w)
    assert torch.equal(S, expect)
    SJ = np.asarray(jmod.source_terms(pj.sim.cc_data.grid,
                                      pj.sim.cc_data.data, pj.sim.ivars,
                                      pj.sim.rp))
    # XLA's CPU flushes subnormal results to zero (convection's weight
    # far from the layer makes some); torch keeps them
    S_np = S.numpy()
    flushed = np.where(np.abs(S_np) < np.finfo(S_np.dtype).tiny, 0.0, S_np)
    assert np.array_equal(flushed, SJ)
    e1, w1 = weight_plane(myg, rp, mod.source_weight, U)
    e2, w2 = weight_plane(myg, rp, mod.source_weight, U)
    assert e1 == e_rate and w1 is w2 and w1.dtype == U.dtype
    _, w32 = weight_plane(myg, rp, mod.source_weight, U.float())
    assert w32.dtype == torch.float32 and torch.equal(
        w32, torch.as_tensor(w, dtype=torch.float32))


@pytest.mark.parametrize("solver", ["compressible_rk", "compressible_fv4",
                                    "compressible_sdc"])
@pytest.mark.parametrize("problem", MOL_INPUTS)
def test_mol_inputs_files_are_the_jax_packages(solver, problem):
    """Each MOL solver's problem directory holds the JAX package's inputs
    file of every problem it re-exports from the base solver, byte for
    byte (the driver looks them up in the solver's own directory)."""
    name = f"solvers/{solver}/problems/inputs.{problem}"
    assert filecmp.cmp(ROOT / "pyro2_tpu" / name,
                       ROOT / "pyro2_tpu_torch" / name, shallow=False)


@pytest.mark.parametrize("solver", ["compressible_rk", "compressible_fv4",
                                    "compressible_sdc"])
def test_mol_solvers_find_sedov_inputs(solver):
    """Pyro(solver).initialize_problem("sedov") reads the solver's own
    inputs.sedov, as the JAX package's does (it exited with "inputs file
    does not exist" before), and sets the same state (fv4 and sdc: cell
    averages, to rtol 1e-12)."""
    pj, pt = _pair(solver, "sedov", {"mesh.ny": 16})
    assert pt.rp.get_param("sedov.r_init") == pj.rp.get_param("sedov.r_init")
    a = np.asarray(pj.sim.cc_data.data)
    np.testing.assert_allclose(pt.sim.cc_data.data.numpy(), a, rtol=1e-12,
                               atol=1e-12 * np.abs(a).max())


def test_carry_simulation_keeps_the_heating():
    """carry_simulation builds the Simulation with the problem's source
    terms, so a carried heating run steps with the heating on: one step
    from the JAX package's state equals the JAX step, and differs from a
    step without the source."""
    pj = JPyro("compressible")
    pj.initialize_problem("heating", inputs_dict={**OPTS, "mesh.ny": 16})
    pj.sim.cc_data.fill_BC_all()
    pj.sim.compute_timestep()
    state = np.asarray(pj.sim.cc_data.data)
    sim = carry_simulation("compressible", "heating", pj.rp.params, state,
                           device="cpu")
    assert sim.problem_source is not None
    sim.dt = pj.sim.dt
    U = sim.cc_data.data
    got = sim._step(U, 0.0, sim.dt)
    pj.sim.evolve()
    g = sim.cc_data.grid
    sl = (slice(None), slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
    a = np.asarray(pj.sim.cc_data.data)[sl]
    np.testing.assert_allclose(got[sl].numpy(), a, rtol=1e-12,
                               atol=1e-12 * np.abs(a).max())
    sim.problem_source = None
    no_heat = sim._make_step()(U, 0.0, sim.dt)
    assert not torch.equal(no_heat[sl], got[sl])
