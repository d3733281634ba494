"""WENO Lax-Friedrichs flux-vector-split fluxes (the port of
pyro2_tpu/solvers/advection_weno/fluxes.py): one 2-D shifted-window WENO
combination per direction."""

import math

import torch

from pyro2_tpu_torch.mesh.reconstruction import _weno_combine


def _fvs2d(q, order, u, alpha, axis):
    """LF flux-vector-split WENO along `axis` of a full padded tensor.

    flux_p is reconstructed left-biased to the i-1/2 face, flux_m
    right-biased.  The shifts wrap around the padded tensor (as the JAX
    package's jnp.roll does); `valid` and `inner` zero every cell a
    wrapped read could reach."""
    flux = u * q
    flux_p = (flux + alpha * q) / 2
    flux_m = (flux - alpha * q) / 2

    def sh(arr, k):
        return torch.roll(arr, -k, dims=axis)

    # flux_p_r[i] combines flux_p[i-1+o], flux_m_l[i] combines flux_m[i-o]
    p_r = _weno_combine(lambda o: sh(flux_p, o - 1), order)
    m_l = _weno_combine(lambda o: sh(flux_m, -o), order)

    n = q.shape[axis]
    idx = torch.arange(n, device=q.device)
    shape = [1, 1]
    shape[axis] = n
    valid = ((idx >= order) & (idx < n - order)).reshape(shape)
    inner = ((idx >= 1) & (idx < n - 1)).reshape(shape)

    recon = torch.where(valid, p_r + m_l, 0.0)
    return torch.where(inner, recon, 0.0)


def fluxes(a, g, rp):
    """(F_x, F_y) WENO fluxes for constant-velocity advection."""
    u = rp.get_param("advection.u")
    v = rp.get_param("advection.v")
    weno_order = rp.get_param("advection.weno_order")
    assert weno_order in (2, 3), "Currently only implemented weno_order=2, 3"
    assert g.ng > weno_order, "Need more ghosts than the weno_order"

    alpha = math.sqrt(u ** 2 + v ** 2)
    F_x = _fvs2d(a, weno_order, u, alpha, axis=0)
    F_y = _fvs2d(a, weno_order, v, alpha, axis=1)
    return F_x, F_y
