"""Unsplit CTU fluxes for linear advection with constant (u, v).

The port of pyro2_tpu/solvers/advection/advective_fluxes.py: limited
slopes -> upwind interface states -> transverse-flux-corrected fluxes, as
whole-tensor windowed ops.  Fluxes are defined on the left edge of each
zone; every result is a full padded tensor, zero outside its buf=1 window.
"""

from pyro2_tpu_torch.mesh import reconstruction
from pyro2_tpu_torch.mesh.indexer import ai, embed

__all__ = ["linear_interface_states", "unsplit_fluxes"]


def linear_interface_states(a, g, u, v, limiter, dt):
    """Upwinded interface states a_{i-1/2}^{n+1/2} for constant velocity
    (u, v, limiter and dt are Python scalars)."""
    cx = u * dt / g.dx
    cy = v * dt / g.dy

    ldelta_ax = reconstruction.limit(a, g, 1, limiter)
    ldelta_ay = reconstruction.limit(a, g, 2, limiter)

    av = ai(a, g)
    ldx = ai(ldelta_ax, g)
    ldy = ai(ldelta_ay, g)

    if u < 0:
        a_x_w = av.v(buf=1) - 0.5 * (1.0 + cx) * ldx.v(buf=1)
    else:
        a_x_w = av.ip(-1, buf=1) + 0.5 * (1.0 - cx) * ldx.ip(-1, buf=1)

    if v < 0:
        a_y_w = av.v(buf=1) - 0.5 * (1.0 + cy) * ldy.v(buf=1)
    else:
        a_y_w = av.jp(-1, buf=1) + 0.5 * (1.0 - cy) * ldy.jp(-1, buf=1)

    return embed(a_x_w, g, 1), embed(a_y_w, g, 1)


def unsplit_fluxes(a, g, u, v, limiter, dt,
                   interface=linear_interface_states):
    """x/y interface fluxes for a_t + u a_x + v a_y = 0 (Colella 1990 CTU).

    The single upwinded state per interface gets a transverse-derivative
    correction, then F = velocity * state."""
    a_x, a_y = interface(a, g, u, v, limiter, dt)

    # transverse fluxes from the predictor states
    F_xt = ai(u * a_x, g)
    F_yt = ai(v * a_y, g)
    axv = ai(a_x, g)
    ayv = ai(a_y, g)

    # which zone the transverse derivative comes from depends on upwinding
    mx = 0 if u <= 0 else -1
    my = 0 if v <= 0 else -1

    dtdx2 = 0.5 * dt / g.dx
    dtdy2 = 0.5 * dt / g.dy

    F_x_w = u * (axv.v(buf=1) -
                 dtdy2 * (F_yt.ip_jp(mx, 1, buf=1) - F_yt.ip(mx, buf=1)))
    F_y_w = v * (ayv.v(buf=1) -
                 dtdx2 * (F_xt.ip_jp(1, my, buf=1) - F_xt.jp(my, buf=1)))

    return embed(F_x_w, g, 1), embed(F_y_w, g, 1)
