"""Interface states, Riemann logic, and fluxes for inviscid Burgers.

The port of pyro2_tpu/solvers/burgers/burgers_interface.py: 'hat'
normal-predictor states, transverse corrections via upwinded hat states,
and F = u^2/2 flux assembly, as whole-tensor windowed ops.

All tensors are full padded (qx, qy); windows are valid on buf=2.  Left
states at interface i-1/2 are stored at index i (written through a +1
shifted window).  No function writes its inputs.
"""

import torch

from pyro2_tpu_torch.mesh.indexer import ai, embed

__all__ = ["get_interface_states", "apply_transverse_corrections",
           "construct_unsplit_fluxes", "upwind", "riemann",
           "riemann_and_upwind"]


def _add(arr, g, vals, buf=2, ishift=0, jshift=0):
    """A copy of arr with a buf-window block added in, shifted."""
    out = arr.clone()
    out[..., g.ilo - buf + ishift:g.ihi + 1 + buf + ishift,
        g.jlo - buf + jshift:g.jhi + 1 + buf + jshift] += vals
    return out


def get_interface_states(g, dt, u, v, ldelta_ux, ldelta_vx,
                         ldelta_uy, ldelta_vy):
    """Normal-predictor ('hat') left/right states of u, v on x/y interfaces."""
    uv = ai(u, g)
    vv = ai(v, g)
    lux = ai(ldelta_ux, g)
    lvx = ai(ldelta_vx, g)
    luy = ai(ldelta_uy, g)
    lvy = ai(ldelta_vy, g)

    dtdx = dt / g.dx
    dtdy = dt / g.dy

    u_b = uv.v(buf=2)
    v_b = vv.v(buf=2)

    # u, v predicted to x-edges (left state lives at i+1)
    u_xl = embed(u_b + 0.5 * (1.0 - dtdx * u_b) * lux.v(buf=2), g, 2,
                 ishift=1)
    u_xr = embed(u_b - 0.5 * (1.0 + dtdx * u_b) * lux.v(buf=2), g, 2)
    v_xl = embed(v_b + 0.5 * (1.0 - dtdx * u_b) * lvx.v(buf=2), g, 2,
                 ishift=1)
    v_xr = embed(v_b - 0.5 * (1.0 + dtdx * u_b) * lvx.v(buf=2), g, 2)

    # u, v predicted to y-edges (left state lives at j+1)
    u_yl = embed(u_b + 0.5 * (1.0 - dtdy * v_b) * luy.v(buf=2), g, 2,
                 jshift=1)
    u_yr = embed(u_b - 0.5 * (1.0 + dtdy * v_b) * luy.v(buf=2), g, 2)
    v_yl = embed(v_b + 0.5 * (1.0 - dtdy * v_b) * lvy.v(buf=2), g, 2,
                 jshift=1)
    v_yr = embed(v_b - 0.5 * (1.0 + dtdy * v_b) * lvy.v(buf=2), g, 2)

    return u_xl, u_xr, u_yl, u_yr, v_xl, v_xr, v_yl, v_yr


def upwind(g, q_l, q_r, s):
    """Select the interface state by the sign of velocity s."""
    sl = ai(s, g).v(buf=2)
    ql = ai(q_l, g).v(buf=2)
    qr = ai(q_r, g).v(buf=2)
    q_int = torch.where(sl == 0.0, 0.5 * (ql + qr),
                        torch.where(sl > 0.0, ql, qr))
    return embed(q_int, g, 2)


def riemann(g, q_l, q_r):
    """Burgers Riemann interface velocity (Almgren, Bell & Szymczak 1996)."""
    ql = ai(q_l, g).v(buf=2)
    qr = ai(q_r, g).v(buf=2)
    s = torch.where((ql <= 0.0) & (qr >= 0.0), 0.0,
                    torch.where((ql > 0.0) & (ql + qr > 0.0), ql, qr))
    return embed(s, g, 2)


def riemann_and_upwind(g, q_l, q_r):
    """Riemann for the interface velocity, then upwind with it."""
    s = riemann(g, q_l, q_r)
    return upwind(g, q_l, q_r, s)


def apply_transverse_corrections(g, dt, u_xl, u_xr, u_yl, u_yr,
                                 v_xl, v_xr, v_yl, v_yr):
    """Add the transverse-derivative terms to the hat states."""
    dtdx = dt / g.dx
    dtdy = dt / g.dy

    # normal advective velocities from the hat states
    uhat_adv = riemann(g, u_xl, u_xr)
    vhat_adv = riemann(g, v_yl, v_yr)

    u_xint = upwind(g, u_xl, u_xr, uhat_adv)
    v_xint = upwind(g, v_xl, v_xr, uhat_adv)
    u_yint = upwind(g, u_yl, u_yr, vhat_adv)
    v_yint = upwind(g, v_yl, v_yr, vhat_adv)

    ua = ai(uhat_adv, g)
    va = ai(vhat_adv, g)
    ubar = 0.5 * (ua.v(buf=2) + ua.ip(1, buf=2))
    vbar = 0.5 * (va.v(buf=2) + va.jp(1, buf=2))

    uyi = ai(u_yint, g)
    vyi = ai(v_yint, g)
    uxi = ai(u_xint, g)
    vxi = ai(v_xint, g)

    du_trans = -0.5 * dtdy * vbar * (uyi.jp(1, buf=2) - uyi.v(buf=2))
    dv_trans_x = -0.5 * dtdy * vbar * (vyi.jp(1, buf=2) - vyi.v(buf=2))
    dv_trans = -0.5 * dtdx * ubar * (vxi.ip(1, buf=2) - vxi.v(buf=2))
    du_trans_y = -0.5 * dtdx * ubar * (uxi.ip(1, buf=2) - uxi.v(buf=2))

    u_xl = _add(u_xl, g, du_trans, ishift=1)
    u_xr = _add(u_xr, g, du_trans)
    v_xl = _add(v_xl, g, dv_trans_x, ishift=1)
    v_xr = _add(v_xr, g, dv_trans_x)
    v_yl = _add(v_yl, g, dv_trans, jshift=1)
    v_yr = _add(v_yr, g, dv_trans)
    u_yl = _add(u_yl, g, du_trans_y, jshift=1)
    u_yr = _add(u_yr, g, du_trans_y)

    return u_xl, u_xr, u_yl, u_yr, v_xl, v_xr, v_yl, v_yr


def construct_unsplit_fluxes(g, u_xl, u_xr, u_yl, u_yr,
                             v_xl, v_xr, v_yl, v_yr):
    """Final Riemann pass and F = q * u_MAC / 2 flux assembly."""
    u_MAC = riemann_and_upwind(g, u_xl, u_xr)
    v_MAC = riemann_and_upwind(g, v_yl, v_yr)

    ux = upwind(g, u_xl, u_xr, u_MAC)
    vx = upwind(g, v_xl, v_xr, u_MAC)
    uy = upwind(g, u_yl, u_yr, v_MAC)
    vy = upwind(g, v_yl, v_yr, v_MAC)

    um = ai(u_MAC, g).v(buf=2)
    vm = ai(v_MAC, g).v(buf=2)

    fu_x = embed(0.5 * ai(ux, g).v(buf=2) * um, g, 2)
    fv_x = embed(0.5 * ai(vx, g).v(buf=2) * um, g, 2)
    fu_y = embed(0.5 * ai(uy, g).v(buf=2) * vm, g, 2)
    fv_y = embed(0.5 * ai(vy, g).v(buf=2) * vm, g, 2)

    return fu_x, fu_y, fv_x, fv_y
