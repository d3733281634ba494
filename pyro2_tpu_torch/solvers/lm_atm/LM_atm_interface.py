"""Low-Mach interface states on tensors.

The port of pyro2_tpu/solvers/lm_atm/LM_atm_interface.py.  Hat states on
the buf=2 window (the left states embedded one zone up); upwind and
Riemann on the asymmetric (lo-1, hi+2) window; the transverse + gradp +
source corrections on the buf=1 window, and rho_states' corrections on
buf=2 -- all with zeros outside their windows, as there.  These are the
plain versions of the CUDA stages in lm_kernel.py.  No function writes its
inputs.
"""

import torch

from pyro2_tpu_torch.mesh.indexer import ai, embed

__all__ = ["mac_vels", "states", "rho_states", "upwind", "riemann",
           "riemann_and_upwind", "get_interface_states"]


def _put(g, vals, buf_lo, buf_hi, ishift=0, jshift=0):
    return embed(vals, g, (buf_lo, buf_hi, buf_lo, buf_hi),
                 ishift=ishift, jshift=jshift)


def _add(arr, g, vals, buf_lo, buf_hi, ishift=0, jshift=0):
    return arr + _put(g, vals, buf_lo, buf_hi, ishift, jshift)


def _w12(a, g):
    """The (lo-1, hi+2) window the reference's upwind/riemann loops use."""
    return ai(a, g).v(buf=(1, 2))


def upwind(g, q_l, q_r, s):
    """Select the interface state by the sign of velocity s."""
    sl = _w12(s, g)
    ql = _w12(q_l, g)
    qr = _w12(q_r, g)
    q_int = torch.where(sl > 0.0, ql,
                        torch.where(sl == 0.0, 0.5 * (ql + qr), qr))
    return _put(g, q_int, 1, 2)


def riemann(g, q_l, q_r):
    """Burgers Riemann interface velocity (ABS 1996)."""
    ql = _w12(q_l, g)
    qr = _w12(q_r, g)
    s = torch.where((ql > 0.0) & (ql + qr > 0.0), ql,
                    torch.where((ql <= 0.0) & (qr >= 0.0), 0.0, qr))
    return _put(g, s, 1, 2)


def riemann_and_upwind(g, q_l, q_r):
    """Riemann then upwind with the resulting interface velocity."""
    s = riemann(g, q_l, q_r)
    return upwind(g, q_l, q_r, s)


def get_interface_states(g, dx, dy, dt, u, v,
                         ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy,
                         gradp_x, gradp_y, source):
    """Unsplit u/v left/right states with transverse + gradp + source
    corrections (the coefficient, e.g. beta0/rho, is pre-multiplied into
    gradp by the caller)."""
    uv = ai(u, g)
    vv = ai(v, g)
    lux = ai(ldelta_ux, g)
    lvx = ai(ldelta_vx, g)
    luy = ai(ldelta_uy, g)
    lvy = ai(ldelta_vy, g)

    dtdx = dt / dx
    dtdy = dt / dy

    u_b = uv.v(buf=2)
    v_b = vv.v(buf=2)

    u_xl = _put(g, u_b + 0.5 * (1.0 - dtdx * u_b) * lux.v(buf=2),
                2, 2, ishift=1)
    u_xr = _put(g, u_b - 0.5 * (1.0 + dtdx * u_b) * lux.v(buf=2), 2, 2)
    v_xl = _put(g, v_b + 0.5 * (1.0 - dtdx * u_b) * lvx.v(buf=2),
                2, 2, ishift=1)
    v_xr = _put(g, v_b - 0.5 * (1.0 + dtdx * u_b) * lvx.v(buf=2), 2, 2)
    u_yl = _put(g, u_b + 0.5 * (1.0 - dtdy * v_b) * luy.v(buf=2),
                2, 2, jshift=1)
    u_yr = _put(g, u_b - 0.5 * (1.0 + dtdy * v_b) * luy.v(buf=2), 2, 2)
    v_yl = _put(g, v_b + 0.5 * (1.0 - dtdy * v_b) * lvy.v(buf=2),
                2, 2, jshift=1)
    v_yr = _put(g, v_b - 0.5 * (1.0 + dtdy * v_b) * lvy.v(buf=2), 2, 2)

    uhat_adv = riemann(g, u_xl, u_xr)
    vhat_adv = riemann(g, v_yl, v_yr)

    u_xint = upwind(g, u_xl, u_xr, uhat_adv)
    v_xint = upwind(g, v_xl, v_xr, uhat_adv)
    u_yint = upwind(g, u_yl, u_yr, vhat_adv)
    v_yint = upwind(g, v_yl, v_yr, vhat_adv)

    # transverse + gradp + source corrections on the buf=1 window
    b = 1
    ua = ai(uhat_adv, g)
    va = ai(vhat_adv, g)
    ubar = 0.5 * (ua.v(buf=b) + ua.ip(1, buf=b))
    vbar = 0.5 * (va.v(buf=b) + va.jp(1, buf=b))

    uyi = ai(u_yint, g)
    vyi = ai(v_yint, g)
    uxi = ai(u_xint, g)
    vxi = ai(v_xint, g)
    gpx = ai(gradp_x, g).v(buf=b)
    gpy = ai(gradp_y, g).v(buf=b)
    src = ai(source, g).v(buf=b)

    vu_y = vbar * (uyi.jp(1, buf=b) - uyi.v(buf=b))
    vv_y = vbar * (vyi.jp(1, buf=b) - vyi.v(buf=b))
    uv_x = ubar * (vxi.ip(1, buf=b) - vxi.v(buf=b))
    uu_x = ubar * (uxi.ip(1, buf=b) - uxi.v(buf=b))

    du_x = -0.5 * dtdy * vu_y - 0.5 * dt * gpx
    dv_x = -0.5 * dtdy * vv_y - 0.5 * dt * gpy + 0.5 * dt * src
    dv_y = -0.5 * dtdx * uv_x - 0.5 * dt * gpy + 0.5 * dt * src
    du_y = -0.5 * dtdx * uu_x - 0.5 * dt * gpx

    u_xl = _add(u_xl, g, du_x, b, b, ishift=1)
    u_xr = _add(u_xr, g, du_x, b, b)
    v_xl = _add(v_xl, g, dv_x, b, b, ishift=1)
    v_xr = _add(v_xr, g, dv_x, b, b)
    v_yl = _add(v_yl, g, dv_y, b, b, jshift=1)
    v_yr = _add(v_yr, g, dv_y, b, b)
    u_yl = _add(u_yl, g, du_y, b, b, jshift=1)
    u_yr = _add(u_yr, g, du_y, b, b)

    return u_xl, u_xr, u_yl, u_yr, v_xl, v_xr, v_yl, v_yr


def mac_vels(g, dx, dy, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy,
             ldelta_vy, gradp_x, gradp_y, source):
    """The MAC advective velocities (u on x-edges, v on y-edges)."""
    u_xl, u_xr, _u_yl, _u_yr, _v_xl, _v_xr, v_yl, v_yr = \
        get_interface_states(g, dx, dy, dt, u, v, ldelta_ux, ldelta_vx,
                             ldelta_uy, ldelta_vy, gradp_x, gradp_y, source)
    u_MAC = riemann_and_upwind(g, u_xl, u_xr)
    v_MAC = riemann_and_upwind(g, v_yl, v_yr)
    return u_MAC, v_MAC


def states(g, dx, dy, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy,
           ldelta_vy, gradp_x, gradp_y, source, u_MAC, v_MAC):
    """Full interface states of u and v, upwinded by the MAC velocities."""
    u_xl, u_xr, u_yl, u_yr, v_xl, v_xr, v_yl, v_yr = \
        get_interface_states(g, dx, dy, dt, u, v, ldelta_ux, ldelta_vx,
                             ldelta_uy, ldelta_vy, gradp_x, gradp_y, source)
    u_xint = upwind(g, u_xl, u_xr, u_MAC)
    v_xint = upwind(g, v_xl, v_xr, u_MAC)
    u_yint = upwind(g, u_yl, u_yr, v_MAC)
    v_yint = upwind(g, v_yl, v_yr, v_MAC)
    return u_xint, v_xint, u_yint, v_yint


def rho_states(g, dx, dy, dt, rho, u_MAC, v_MAC, ldelta_rx, ldelta_ry):
    """Predict rho to the interfaces, upwinding by the MAC velocities."""
    rv = ai(rho, g)
    um = ai(u_MAC, g)
    vm = ai(v_MAC, g)
    lrx = ai(ldelta_rx, g)
    lry = ai(ldelta_ry, g)

    dtdx = dt / dx
    dtdy = dt / dy

    rho_b = rv.v(buf=2)

    rho_xl = _put(g, rho_b + 0.5 * (1.0 - dtdx * um.ip(1, buf=2)) *
                  lrx.v(buf=2), 2, 2, ishift=1)
    rho_xr = _put(g, rho_b - 0.5 * (1.0 + dtdx * um.v(buf=2)) *
                  lrx.v(buf=2), 2, 2)
    rho_yl = _put(g, rho_b + 0.5 * (1.0 - dtdy * vm.jp(1, buf=2)) *
                  lry.v(buf=2), 2, 2, jshift=1)
    rho_yr = _put(g, rho_b - 0.5 * (1.0 + dtdy * vm.v(buf=2)) *
                  lry.v(buf=2), 2, 2)

    rho_xint = upwind(g, rho_xl, rho_xr, u_MAC)
    rho_yint = upwind(g, rho_yl, rho_yr, v_MAC)

    # transverse terms + non-advective normal divergence, on buf=2
    b = 2
    rxi = ai(rho_xint, g)
    ryi = ai(rho_yint, g)
    u_x = (um.ip(1, buf=b) - um.v(buf=b)) / dx
    v_y = (vm.jp(1, buf=b) - vm.v(buf=b)) / dy
    rhov_y = (ryi.jp(1, buf=b) * vm.jp(1, buf=b) -
              ryi.v(buf=b) * vm.v(buf=b)) / dy
    rhou_x = (rxi.ip(1, buf=b) * um.ip(1, buf=b) -
              rxi.v(buf=b) * um.v(buf=b)) / dx

    dx_corr = -0.5 * dt * (rhov_y + rho_b * u_x)
    dy_corr = -0.5 * dt * (rhou_x + rho_b * v_y)

    rho_xl = _add(rho_xl, g, dx_corr, b, b, ishift=1)
    rho_xr = _add(rho_xr, g, dx_corr, b, b)
    rho_yl = _add(rho_yl, g, dy_corr, b, b, jshift=1)
    rho_yr = _add(rho_yr, g, dy_corr, b, b)

    rho_xint = upwind(g, rho_xl, rho_xr, u_MAC)
    rho_yint = upwind(g, rho_yl, rho_yr, v_MAC)
    return rho_xint, rho_yint
