"""Parity of the port's limiters and flattening with pyro2_tpu
(rtol 1e-13, float64, numpy-seeded inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyro2_tpu.mesh import reconstruction as jrec
from pyro2_tpu.mesh.grid import Cartesian2d as JCartesian2d
from pyro2_tpu_torch.mesh import reconstruction as trec
from pyro2_tpu_torch.mesh.grid import Cartesian2d


class IV:
    nq = 4
    irho, iu, iv, ip = 0, 1, 2, 3


class RP:
    params = {"compressible.delta": 0.33, "compressible.z0": 0.75,
              "compressible.z1": 0.85}

    def get_param(self, key):
        return self.params[key]


def _close(want, got):
    want = np.asarray(want)
    got = got.numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13 * scale)


def _grids(nx, ny):
    return JCartesian2d(nx, ny, ng=4), Cartesian2d(nx, ny, ng=4)


@pytest.mark.parametrize("limiter", [0, 1, 2])
@pytest.mark.parametrize("idir", [1, 2])
@pytest.mark.parametrize("nx,ny", [(32, 24), (20, 36)])
def test_limiters_match_jax(limiter, idir, nx, ny):
    jg, tg = _grids(nx, ny)
    rng = np.random.default_rng(limiter + 3 * idir + nx)
    # a rough field with flat patches, so every MC branch is taken
    a = np.round(rng.standard_normal((tg.qx, tg.qy)), 1)
    want = jrec.limit(jnp.asarray(a), jg, idir, limiter)
    got = trec.limit(torch.as_tensor(a), tg, idir, limiter)
    _close(want, got)


def _prims(tg, seed):
    rng = np.random.default_rng(seed)
    shape = (tg.qx, tg.qy)
    p = 1.0 + rng.random(shape)
    p[::5] *= 10.0                      # shocks for the flattening
    return np.stack([1.0 + rng.random(shape), rng.standard_normal(shape),
                     rng.standard_normal(shape), p])


@pytest.mark.parametrize("idir", [1, 2])
@pytest.mark.parametrize("nx,ny", [(32, 24), (20, 36)])
def test_flatten_matches_jax(idir, nx, ny):
    jg, tg = _grids(nx, ny)
    q = _prims(tg, idir + nx)
    want = jrec.flatten(jg, jnp.asarray(q), idir, IV, RP())
    got = trec.flatten(tg, torch.as_tensor(q), idir, IV, RP())
    _close(want, got)
    assert float(got.min()) < 1.0       # flattening switched on somewhere


@pytest.mark.parametrize("nx,ny", [(32, 24), (20, 36)])
def test_flatten_multid_matches_jax(nx, ny):
    jg, tg = _grids(nx, ny)
    q = _prims(tg, nx)
    jq, tq = jnp.asarray(q), torch.as_tensor(q)
    jx = jrec.flatten(jg, jq, 1, IV, RP())
    jy = jrec.flatten(jg, jq, 2, IV, RP())
    tx = trec.flatten(tg, tq, 1, IV, RP())
    ty = trec.flatten(tg, tq, 2, IV, RP())
    want = jrec.flatten_multid(jg, jq, jx, jy, IV)
    got = trec.flatten_multid(tg, tq, tx, ty, IV)
    _close(want, got)
