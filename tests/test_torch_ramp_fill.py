"""The ramp's ghost fills on the device (compressible/BC.py ramp_top_rows,
ramp_geometry): the top ghosts' moving shock front computed from a 0-d
tensor t, as the on-device loop's fill_bc_stack(U, t) gives it, equals the
fill from the host loop's float t by bits in float64, at several t, among
them one at which the front crosses a top ghost cell (a cell that blends
the post- and pre-shock states).  Both equal the JAX package's fill, traced
t and float t.  On the CPU, float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro2_tpu import Pyro as JPyro
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.solvers.compressible import BC

INPUTS = {"mesh.nx": 24, "mesh.ny": 8}
POST_DENS, PRE_DENS = 8.0, 1.4


def _ramp(P, **kw):
    p = P("compressible", **kw)
    p.initialize_problem("ramp", inputs_dict=INPUTS)
    return p.sim


@pytest.fixture(scope="module")
def sims():
    tsim = _ramp(Pyro, device="cpu")
    jsim = _ramp(JPyro)
    rng = np.random.default_rng(3)
    U = tsim.cc_data.data.numpy() * (1.0 + 0.1 * rng.random(
        tsim.cc_data.data.shape))
    return tsim, jsim, U


def _crossing_t(myg):
    """A t at which the front's lower quadrature ordinate of the first top
    ghost row lies halfway between the two abscissae of cell nx // 2."""
    cx, offset, _ = BC.ramp_geometry(myg, torch.zeros((), dtype=torch.float64))
    i = myg.ilo + myg.nx // 2
    mid = 0.5 * (float(cx[0, i]) + float(cx[1, i]))
    return (mid - float(offset[0, 0])) / BC._FRONT_SPEED


def _top(U, myg):
    return np.asarray(U)[:, :, myg.jhi + 1:]


@pytest.mark.parametrize("which", ["zero", "early", "crossing", "late"])
def test_tensor_t_fill_equals_float_t_fill_by_bits(sims, which):
    tsim, jsim, U = sims
    myg = tsim.cc_data.grid
    t = {"zero": 0.0, "early": 0.0137, "crossing": _crossing_t(myg),
         "late": 0.2}[which]
    d = tsim.cc_data
    by_float = d.fill_bc_stack(torch.tensor(U), t)
    by_tensor = d.fill_bc_stack(torch.tensor(U),
                                torch.tensor(t, dtype=torch.float64))
    assert np.array_equal(by_float.numpy(), by_tensor.numpy())
    assert d.t == 0.0
    dens = _top(by_tensor, myg)[d.names.index("density")]
    blended = (dens != POST_DENS) & (dens != PRE_DENS)
    if which == "crossing":
        i = myg.ilo + myg.nx // 2
        assert blended[i, 0]
    else:
        assert blended.any() or which == "zero"

    # the JAX package's fill: float t on the host, traced t under jit
    jd = jsim.cc_data
    want = np.asarray(jd.fill_bc_stack(jnp.asarray(U), t))
    traced = np.asarray(jax.jit(lambda s, tt: jd.fill_bc_stack(s, tt))(
        jnp.asarray(U), jnp.asarray(t, jnp.float64)))
    np.testing.assert_allclose(by_tensor.numpy(), want, rtol=1e-15, atol=0)
    np.testing.assert_allclose(by_tensor.numpy(), traced, rtol=1e-15,
                               atol=0)


def test_the_top_rows_move_with_t(sims):
    """Later fronts lie further along x: more of each top row is post-shock
    (density 8), and each row is the host's order of the quadrature sum."""
    tsim, _, _ = sims
    myg = tsim.cc_data.grid
    like = torch.zeros((), dtype=torch.float64)
    rows = [BC.ramp_top_rows(myg, t, POST_DENS, PRE_DENS, like)
            for t in (0.0, 0.05, 0.1)]
    post = [int((r == POST_DENS).sum()) for r in rows]
    assert post[0] < post[1] < post[2]
    assert rows[0].shape == (myg.qx, myg.ng)


def test_the_geometry_is_made_once_per_dtype_and_device(sims):
    tsim, _, _ = sims
    myg = tsim.cc_data.grid
    f64 = torch.zeros((), dtype=torch.float64)
    f32 = torch.zeros((), dtype=torch.float32)
    a = BC.ramp_geometry(myg, f64)
    assert all(x is y for x, y in zip(a, BC.ramp_geometry(myg, f64)))
    b = BC.ramp_geometry(myg, f32)
    assert b[0].dtype == b[1].dtype == torch.float32
    assert b[2].dtype == torch.bool
    assert np.array_equal(a[2].numpy(), myg.x < 1.0 / 6.0)
