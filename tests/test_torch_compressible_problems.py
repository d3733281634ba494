"""The port's compressible problems that need no new kernel coverage
(bubble, gresho, hse, logo, ramp, rt2, rt_multimode, sedov), held to
pyro2_tpu.

For each: the initial state from init_data (with the problem's inputs
file, at 32^2) equal to the JAX package's bit for bit, then 3 steps through
Pyro on the CPU in float64, every variable's interior at rtol 1e-12 (atol
1e-12 of the largest value of the whole state, so that a momentum which
is zero up to roundoff is held to the state's scale).  bubble runs on
32x128: its discretely hydrostatic atmosphere (dens_base 1000, scale height
1 over 8 units) integrates to a negative pressure at the top at dy 1/4 and
1/8 in both packages.  sedov runs on both of its grids;
the spherical one on r in [0.05, 1], theta in [pi/4, 3 pi/4], r_init 0.1,
CGF, at 96x32: with 4 ghost cells the grid needs nx >= 76 to keep r >= 0
in the ghosts (SphericalPolar's own assertion).

logo: under numpy >= 2 the JAX package's init_data raises OverflowError
on 256 - uint8; the port widens the channel first, as numpy 1 did.  The
JAX side is run with its numpy's frombuffer widened the same way.
"""

import numpy as np
import pytest

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu.solvers.compressible.problems import logo as jlogo
from pyro2_tpu_torch import Pyro

OPTS = {"driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0,
        "mesh.nx": 32, "mesh.ny": 32, "driver.max_steps": 3,
        "driver.tmax": 1.0e30}
CASES = {
    "bubble": ("bubble", {"mesh.ny": 128}),
    "gresho": ("gresho", {}),
    "hse": ("hse", {}),
    "logo": ("logo", {}),
    "ramp": ("ramp", {}),
    "rt2": ("rt2", {}),
    "rt_multimode": ("rt_multimode", {}),
    "sedov": ("sedov", {}),
    "sedov_spherical": ("sedov", {
        "mesh.grid_type": "SphericalPolar", "mesh.nx": 96,
        "mesh.xmin": 0.05, "mesh.xmax": 1.0,
        "mesh.ymin": 0.7853981633974483, "mesh.ymax": 2.356194490192345,
        "compressible.riemann": "CGF", "sedov.r_init": 0.1}),
}


class _WideNumpy:
    """numpy, with frombuffer's uint8 widened (numpy 1's 256 - uint8)."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def frombuffer(buf, dtype=None):
        return np.frombuffer(buf, dtype=dtype).astype(np.int64)


@pytest.mark.parametrize("case", list(CASES))
def test_problem_matches_jax(case, monkeypatch):
    problem, extra = CASES[case]
    if problem == "logo":
        pytest.importorskip("matplotlib")
        monkeypatch.setattr(jlogo, "np", _WideNumpy())
    inputs = {**OPTS, **extra}
    pj = JPyro("compressible")
    pj.initialize_problem(problem, inputs_dict=inputs)
    pt = Pyro("compressible", device="cpu")
    pt.initialize_problem(problem, inputs_dict=inputs)
    names = pj.sim.cc_data.names
    assert pt.sim.cc_data.names == names
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


def test_jax_logo_overflows_under_numpy_2():
    pytest.importorskip("matplotlib")
    if int(np.__version__.split(".")[0]) < 2:
        pytest.skip("numpy 1 widens 256 - uint8")
    pj = JPyro("compressible")
    with pytest.raises(OverflowError):
        pj.initialize_problem("logo", inputs_dict=OPTS)
