"""compressible_react in the port, held to pyro2_tpu in float64 on the
CPU: the CTU solver with the passive species fuel and ash (nvar 6) in a
Strang scaffold whose burn and diffuse are stubs.

  * init_data of flame and of the react rt module equal to the JAX
    package's bit for bit, called directly and through Pyro;
  * 3 steps of flame and rt through Pyro, every variable's interior at
    rtol 1e-12 (atol 1e-12 max|U|);
  * the problems package: flame, rt and the base problems but rt, as the
    JAX package lists them.  Its aliasing of the base problems, which the
    JAX package does the same way, puts the base compressible rt under
    the react rt's module name, so Pyro's rt in both packages is the base
    rt with fuel and ash at zero (ROADMAP C.4);
  * the driver knows all 17 of the JAX package's solvers.
"""

import importlib
import importlib.util
import pathlib

import numpy as np
import pytest

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu import pyro_sim as jpyro_sim
from pyro2_tpu.mesh.patch import CellCenterData2d as JData
from pyro2_tpu.mesh.grid import Cartesian2d as JCartesian2d
from pyro2_tpu_torch import Pyro, pyro_sim
from pyro2_tpu_torch.mesh.grid import Cartesian2d
from pyro2_tpu_torch.mesh.patch import CellCenterData2d
from pyro2_tpu_torch.util.runparams import RuntimeParameters

ROOT = pathlib.Path(__file__).resolve().parent.parent
OPTS = {"driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0,
        "driver.max_steps": 3, "driver.tmax": 1.0e30}
GRIDS = {"flame": {"mesh.nx": 16, "mesh.ny": 16},
         "rt": {"mesh.nx": 16, "mesh.ny": 48},
         "sedov": {"mesh.nx": 16, "mesh.ny": 16}}


def _pair(problem):
    inputs = {**OPTS, **GRIDS[problem]}
    pj = JPyro("compressible_react")
    pj.initialize_problem(problem, inputs_dict=inputs)
    pt = Pyro("compressible_react", device="cpu")
    pt.initialize_problem(problem, inputs_dict=inputs)
    return pj, pt


@pytest.mark.parametrize("problem", ["flame", "rt", "sedov"])
def test_init_and_steps_match_jax(problem):
    pj, pt = _pair(problem)
    names = pj.sim.cc_data.names
    assert pt.sim.cc_data.names == names == [
        "density", "energy", "x-momentum", "y-momentum", "fuel", "ash"]
    for name in names:
        assert np.array_equal(pt.get_var(name).numpy(),
                              np.asarray(pj.get_var(name))), name
    for _ in range(3):
        pj.single_step()
        pt.single_step()
    assert pt.sim.n == pj.sim.n == 3
    assert pt.sim.cc_data.t == pytest.approx(pj.sim.cc_data.t, rel=1e-12)
    g = pt.get_grid()
    sl = (slice(None), slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
    a = np.asarray(pj.sim.cc_data.data)[sl]
    b = pt.sim.cc_data.data[sl].numpy()
    assert np.isfinite(a).all()
    for n, name in enumerate(names):
        np.testing.assert_allclose(b[n], a[n], rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max(),
                                   err_msg=name)


@pytest.mark.parametrize("problem", ["flame", "rt"])
def test_react_init_data_called_directly(problem):
    """The react modules' init_data on a bare container with the react
    inputs, bit for bit (the react rt sets fuel above and ash below)."""
    # each package aliases the base rt under the react rt's name: load the
    # files themselves
    def load(package):
        path = ROOT / package / "solvers" / "compressible_react" / \
            "problems" / f"{problem}.py"
        spec = importlib.util.spec_from_file_location(
            f"_{package}_react_{problem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    jmod, tmod = load("pyro2_tpu"), load("pyro2_tpu_torch")

    pj = JPyro("compressible_react")
    pj.initialize_problem(problem, inputs_dict={**OPTS, **GRIDS[problem]})
    rp = pj.rp
    nx, ny = GRIDS[problem]["mesh.nx"], GRIDS[problem]["mesh.ny"]
    kw = dict(xmax=rp.get_param("mesh.xmax"), ymax=rp.get_param("mesh.ymax"))
    jd = JData(JCartesian2d(nx, ny, ng=4, **kw))
    td = CellCenterData2d(Cartesian2d(nx, ny, ng=4, **kw), device="cpu")
    trp = RuntimeParameters()
    trp.params = dict(rp.params)
    for d in (jd, td):
        for name in pj.sim.cc_data.names:
            d.register_var(name, pj.sim.cc_data.BCs[name])
        d.create()
    jmod.init_data(jd, rp)
    tmod.init_data(td, trp)
    assert np.array_equal(td.data.numpy(), np.asarray(jd.data))
    if problem == "rt":
        assert td.get_var("fuel").max() > 0 and td.get_var("ash").max() > 0


def test_problems_package_and_the_shadowed_rt():
    from pyro2_tpu.solvers.compressible_react import problems as jprobs
    from pyro2_tpu_torch.solvers.compressible_react import problems

    assert problems.__all__ == jprobs.__all__
    assert problems.__all__[:2] == ["flame", "rt"]
    assert importlib.import_module(
        "pyro2_tpu_torch.solvers.compressible_react.problems.rt").__name__ \
        == "pyro2_tpu_torch.solvers.compressible.problems.rt"
    pj, pt = _pair("rt")
    assert not pt.get_var("fuel").any() and not pt.get_var("ash").any()
    assert not np.asarray(pj.get_var("fuel")).any()


def test_driver_knows_all_17_solvers():
    assert sorted(pyro_sim.valid_solvers) == sorted(jpyro_sim.valid_solvers)
    assert len(pyro_sim.valid_solvers) == 17


def test_strang_scaffold_calls_its_stubs_around_the_step():
    pt = Pyro("compressible_react", device="cpu")
    pt.initialize_problem("flame", inputs_dict={**OPTS, **GRIDS["flame"]})
    calls = []
    sim = pt.sim
    sim.burn = lambda dt: calls.append(("burn", dt))
    sim.diffuse = lambda dt: calls.append(("diffuse", dt))
    pt.single_step()
    half = sim.dt / 2
    assert calls == [("burn", half), ("diffuse", half), ("diffuse", half),
                     ("burn", half)]
