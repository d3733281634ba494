"""Unsplit CTU fluxes for non-uniform-velocity advection (the port of
pyro2_tpu/solvers/advection_nonuniform/advective_fluxes.py): per-cell
upwinding as torch.where selects between the two shift values (0, -1)."""

import torch

from pyro2_tpu_torch.mesh import reconstruction
from pyro2_tpu_torch.mesh.indexer import ai, embed


def unsplit_fluxes(a, u, v, shift_x, shift_y, g, rp, dt):
    """(F_x, F_y) with per-cell upwinding by the stored shift masks; full
    padded tensors, zero outside their buf=1 window."""
    cx = u * dt / g.dx
    cy = v * dt / g.dy

    limiter = rp.get_param("advection.limiter")
    ldelta_ax = reconstruction.limit(a, g, 1, limiter)
    ldelta_ay = reconstruction.limit(a, g, 2, limiter)

    av = ai(a, g)
    uv = ai(u, g)
    vv = ai(v, g)
    cxv = ai(cx, g)
    cyv = ai(cy, g)
    ldx = ai(ldelta_ax, g)
    ldy = ai(ldelta_ay, g)
    shx = ai(shift_x, g)
    shy = ai(shift_y, g)

    b = 1

    # shift is 0 (vel <= 0) or -1 (vel > 0): select the shifted reads
    def sel_x(arr_ai):
        return torch.where(shx.v(buf=b) == 0, arr_ai.v(buf=b),
                           arr_ai.ip(-1, buf=b))

    def sel_y(arr_ai):
        return torch.where(shy.v(buf=b) == 0, arr_ai.v(buf=b),
                           arr_ai.jp(-1, buf=b))

    slope_term_x = torch.where(uv.v(buf=b) < 0,
                               -0.5 * (1.0 + cxv.v(buf=b)) * sel_x(ldx),
                               0.5 * (1.0 - cxv.v(buf=b)) * sel_x(ldx))
    a_x = embed(sel_x(av) + slope_term_x, g, b)

    slope_term_y = torch.where(vv.v(buf=b) < 0,
                               -0.5 * (1.0 + cyv.v(buf=b)) * sel_y(ldy),
                               0.5 * (1.0 - cyv.v(buf=b)) * sel_y(ldy))
    a_y = embed(sel_y(av) + slope_term_y, g, b)

    fxt = ai(u * a_x, g)
    fyt = ai(v * a_y, g)

    dtdx2 = 0.5 * dt / g.dx
    dtdy2 = 0.5 * dt / g.dy

    # transverse derivative taken from the upwind zone (shift select)
    dFy = torch.where(shx.v(buf=b) == 0,
                      fyt.jp(1, buf=b) - fyt.v(buf=b),
                      fyt.ip_jp(-1, 1, buf=b) - fyt.ip(-1, buf=b))
    F_x_w = uv.v(buf=b) * (ai(a_x, g).v(buf=b) - dtdy2 * dFy)

    dFx = torch.where(shy.v(buf=b) == 0,
                      fxt.ip(1, buf=b) - fxt.v(buf=b),
                      fxt.ip_jp(1, -1, buf=b) - fxt.jp(-1, buf=b))
    F_y_w = vv.v(buf=b) * (ai(a_y, g).v(buf=b) - dtdx2 * dFx)

    return embed(F_x_w, g, b), embed(F_y_w, g, b)
