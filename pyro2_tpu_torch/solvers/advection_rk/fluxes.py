"""1-D upwind interface fluxes for method-of-lines advection (the port of
pyro2_tpu/solvers/advection_rk/fluxes.py)."""

from pyro2_tpu_torch.mesh import reconstruction
from pyro2_tpu_torch.mesh.indexer import ai, embed


def fluxes(a, g, rp):
    """(F_x, F_y) from piecewise-linear 1-D upwind states (no transverse
    terms: the RK stages couple the directions)."""
    u = rp.get_param("advection.u")
    v = rp.get_param("advection.v")
    limiter = rp.get_param("advection.limiter")

    ldelta_ax = reconstruction.limit(a, g, 1, limiter)
    ldelta_ay = reconstruction.limit(a, g, 2, limiter)

    av = ai(a, g)
    ldx = ai(ldelta_ax, g)
    ldy = ai(ldelta_ay, g)

    if u < 0:
        a_x_w = av.v(buf=1) - 0.5 * ldx.v(buf=1)
    else:
        a_x_w = av.ip(-1, buf=1) + 0.5 * ldx.ip(-1, buf=1)
    if v < 0:
        a_y_w = av.v(buf=1) - 0.5 * ldy.v(buf=1)
    else:
        a_y_w = av.jp(-1, buf=1) + 0.5 * ldy.jp(-1, buf=1)

    return u * embed(a_x_w, g, 1), v * embed(a_y_w, g, 1)
