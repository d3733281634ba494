"""Parity of the port's inviscid Burgers solver, Pyro("burgers"), with
pyro2_tpu, and its golden.

Both packages build each problem with their own problem module and step it
through Pyro on the CPU in float64 (JAX x64).  Tolerances:
  * initial data: exact, every cell of the state, ghosts included (the
    same numpy expressions);
  * 1 and 10 steps: the state to 1e-12 max|U|, each dt and t to 1e-12
    relative.  The JAX steps run with jax.disable_jit(), its jnp operations
    one by one: XLA's fused, jitted update differs from them by an ulp in
    some cells (an FMA), and in tophat a velocity tie of the Riemann
    upwinding turns that ulp into 2e-11 of max|U| by step 10.  Against the
    eager steps the port's agree bit for bit;
  * the golden test_0051.h5 (pyro2_tpu/test.py's burgers run): each
    variable over the valid region with numpy.allclose at rtol 1e-12, the
    step count and time equal;
  * the shock-front measure of problems/verify.py: the diagonal profile
    exact against the JAX package's on the same state.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu.solvers.burgers.problems import verify as jverify
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.mesh.patch import cell_center_data_clone
from pyro2_tpu_torch.pyro_sim import valid_solvers
from pyro2_tpu_torch.solvers.burgers.problems import verify
from pyro2_tpu_torch.util.carry import carry_simulation

GOLDEN = (Path(__file__).resolve().parents[1] / "pyro2_tpu" / "solvers" /
          "burgers" / "tests" / "test_0051.h5")

# (problem, n): the sizes of the parity runs
RUNS = [("tophat", 32), ("converge", 32), ("test", 64)]


def _jax_step(pj):
    """One JAX step, its jnp operations run one by one (see above)."""
    with jax.disable_jit():
        pj.single_step()


def _pair(problem, n, solver="burgers"):
    inputs = {"mesh.nx": n, "mesh.ny": n}
    pj = JPyro(solver)
    pj.initialize_problem(problem, inputs_dict=inputs)
    pt = Pyro(solver, device="cpu")
    pt.initialize_problem(problem, inputs_dict=inputs)
    return pj, pt


def _close(ref, got, tol):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape
    err = np.abs(ref - got).max()
    assert err <= tol * np.abs(ref).max(), err


def test_burgers_is_a_pyro_solver():
    assert "burgers" in valid_solvers
    p = Pyro("burgers", device="cpu")
    p.initialize_problem("tophat", inputs_dict={"mesh.nx": 8,
                                                "mesh.ny": 8})
    assert p.sim.cc_data.data.dtype == torch.float64
    assert p.sim._step is not None


@pytest.mark.parametrize("problem,n", RUNS)
def test_initial_data_matches_jax(problem, n):
    pj, pt = _pair(problem, n)
    assert pt.sim.cc_data.names == pj.sim.cc_data.names
    assert np.array_equal(np.asarray(pj.sim.cc_data.data),
                          pt.sim.cc_data.data.numpy())


@pytest.mark.parametrize("steps", [1, 10])
@pytest.mark.parametrize("problem,n", RUNS)
def test_steps_match_jax(problem, n, steps):
    pj, pt = _pair(problem, n)
    for _ in range(steps):
        _jax_step(pj)
        pt.single_step()
        assert pt.sim.dt == pytest.approx(pj.sim.dt, rel=1e-12)
    assert pt.sim.n == pj.sim.n == steps
    assert pt.sim.cc_data.t == pytest.approx(pj.sim.cc_data.t, rel=1e-12)
    _close(pj.sim.cc_data.data, pt.sim.cc_data.data, 1e-12)


def test_a_carried_mid_run_state_steps_as_jax_does():
    pj, _ = _pair("tophat", 32)
    for _ in range(3):
        _jax_step(pj)
    jsim = pj.sim
    sim = carry_simulation("burgers", "tophat", jsim.rp.params,
                           np.asarray(jsim.cc_data.data), t=jsim.cc_data.t,
                           n=jsim.n, device="cpu")
    sim.dt_old = jsim.dt_old        # the time loop's history, not state
    with jax.disable_jit():
        for s in (jsim, sim):
            s.cc_data.fill_BC_all()
            s.compute_timestep()
            s.evolve()
    assert sim.dt == pytest.approx(jsim.dt, rel=1e-12)
    _close(jsim.cc_data.data, sim.cc_data.data, 1e-12)


def test_front_measure_matches_jax():
    """verify.py's diagonal profile of the test problem's state, and the
    front speed between two states of one run."""
    pj, pt = _pair("test", 32)
    states = []
    for k in range(12):
        _jax_step(pj)
        pt.single_step()
        if k in (3, 11):
            xj, uj = jverify._diag_profile(pj.sim.cc_data)
            xt, ut = verify._diag_profile(pt.sim.cc_data)
            assert np.array_equal(xj, xt)
            _close(uj, ut, 1e-12)
            states.append(cell_center_data_clone(pt.sim.cc_data))
    speed, theo = verify.front_speed(*states, verbose=False)
    assert theo == np.sqrt(8.0)
    (x1, u1), (x2, u2) = map(verify._diag_profile, states)
    thr = 0.9 * theo
    expect = np.sqrt(2.0) * (jverify._front_position(x2, u2, thr) -
                             jverify._front_position(x1, u1, thr)) / \
        (states[1].t - states[0].t)
    assert speed == expect
    with pytest.raises(RuntimeError, match="later"):
        verify.front_speed(states[1], states[0], verbose=False)


def test_verify_command_line_waits_for_a15(tmp_path):
    """A.15 is done: the command line reads two output files through
    util/io_pyro.read (tests/test_torch_io.py holds its output to the JAX
    verify's); a missing file fails as an open does."""
    p = Pyro("burgers", device="cpu")
    p.initialize_problem("test", inputs_dict={"mesh.nx": 32,
                                              "mesh.ny": 32})
    files = []
    for k in range(12):
        p.single_step()
        if k in (3, 11):
            files.append(str(tmp_path / f"test_{k:04d}"))
            p.sim.write(files[-1])
    speed, theo = verify.main(["--device", "cpu", *files])
    assert theo == np.sqrt(8.0) and np.isfinite(speed)
    with pytest.raises(FileNotFoundError):
        verify.main(["--device", "cpu", "a.h5", "b.h5"])


def test_test_problem_matches_golden():
    h5py = pytest.importorskip("h5py")
    p = Pyro("burgers", device="cpu")
    p.initialize_problem("test", inputs_file="inputs.test", inputs_dict={
        "driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0})
    p.run_sim()
    g = p.get_grid()
    with h5py.File(GOLDEN, "r") as f:
        assert int(f.attrs["nsteps"]) == p.sim.n == 51
        assert float(f.attrs["time"]) == pytest.approx(p.sim.cc_data.t,
                                                       rel=1e-12)
        names = sorted(f["state"])
        assert names == sorted(p.sim.cc_data.names)
        for name in names:
            ref = f["state"][name]["data"][()]
            got = p.get_var(name)[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1].numpy()
            assert np.allclose(got, ref, rtol=1e-12), \
                (name, np.abs(got - ref).max())
