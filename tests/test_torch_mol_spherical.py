"""The method-of-lines solvers on a SphericalPolar grid, held to
pyro2_tpu in float64 on the CPU.

The Sedov blast on r in [0.05, 1] (nx 96 keeps the ghosts' radii
positive), r_init 0.1, 3 steps through Pyro, every variable's interior at
rtol 1e-12 (atol 1e-12 max|U|): compressible_rk with CGF and with HLLC_lm
(the CTU solver's CGF-only check does not reach the MOL tier, as in JAX),
compressible_fv4 with its CGF on theta in [pi/4, pi/4 + 32 dr] (fv4's
averages need square cells, dr = dtheta).  The JAX package's MOL stage
takes the spherical sources but divides Cartesian flux differences by dx
and dy; the port reproduces that.  HLLC stays refused on a spherical grid
in every solver, as the JAX package's msg.fail refuses it.
"""

import numpy as np
import pytest

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu_torch import Pyro

OPTS = {"driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0,
        "driver.max_steps": 3, "driver.tmax": 1.0e30,
        "mesh.grid_type": "SphericalPolar", "mesh.nx": 96, "mesh.ny": 32,
        "mesh.xmin": 0.05, "mesh.xmax": 1.0,
        "mesh.ymin": 0.7853981633974483, "mesh.ymax": 2.356194490192345,
        "sedov.r_init": 0.1}
SQUARE = {"mesh.ymax": 0.7853981633974483 + 32 * 0.95 / 96}


@pytest.mark.parametrize("solver,riemann", [
    ("compressible_rk", "CGF"), ("compressible_rk", "HLLC_lm"),
    ("compressible_fv4", "CGF")])
def test_spherical_sedov_matches_jax(solver, riemann):
    inputs = {**OPTS, "compressible.riemann": riemann}
    if solver == "compressible_fv4":
        inputs.update(SQUARE)
    pj = JPyro(solver)
    pj.initialize_problem("sedov", inputs_dict=inputs)
    pt = Pyro(solver, device="cpu")
    pt.initialize_problem("sedov", inputs_dict=inputs)
    assert pt.sim._step.spherical and pt.sim._step.extended
    for _ in range(3):
        pj.single_step()
        pt.single_step()
    assert pt.sim.cc_data.t == pytest.approx(pj.sim.cc_data.t, rel=1e-12)
    g = pt.get_grid()
    sl = (slice(None), slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
    a = np.asarray(pj.sim.cc_data.data)[sl]
    b = pt.sim.cc_data.data[sl].numpy()
    assert np.isfinite(a).all()
    for n, name in enumerate(pt.sim.cc_data.names):
        np.testing.assert_allclose(b[n], a[n], rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max(),
                                   err_msg=name)


@pytest.mark.parametrize("solver", ["compressible_rk", "compressible_fv4",
                                    "compressible_sdc", "compressible"])
def test_spherical_hllc_fails_as_in_jax(solver):
    inputs = {**OPTS, **SQUARE, "compressible.riemann": "HLLC"}
    with pytest.raises(RuntimeError, match="HLLC Riemann Solver is not "
                       "supported with SphericalPolar"):
        Pyro(solver, device="cpu").initialize_problem("sedov",
                                                      inputs_dict=inputs)
