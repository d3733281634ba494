"""4th-order face-average advective fluxes (McCorquodale & Colella
Eqs. 17-20; the port of pyro2_tpu/solvers/advection_fv4/fluxes.py):
4th-order face interpolation (limiter 0) or limited states, then the
face-average <-> face-center transverse Laplacian corrections."""

from pyro2_tpu_torch.mesh import fourth_order
from pyro2_tpu_torch.mesh.indexer import ai, embed


def fluxes(a, g, rp):
    """(F_x, F_y) face-averaged fluxes for constant-velocity advection."""
    u = rp.get_param("advection.u")
    v = rp.get_param("advection.v")
    limiter = rp.get_param("advection.limiter")

    av = ai(a, g)

    if limiter == 0:
        # simple 4th-order interpolation to faces (MC Eq. 17)
        a_x = embed(7. / 12. * (av.ip(-1, buf=1) + av.v(buf=1)) -
                    1. / 12. * (av.ip(-2, buf=1) + av.ip(1, buf=1)), g, 1)
        a_y = embed(7. / 12. * (av.jp(-1, buf=1) + av.v(buf=1)) -
                    1. / 12. * (av.jp(-2, buf=1) + av.jp(1, buf=1)), g, 1)
    else:
        a_l, a_r = fourth_order.states(a, g, 1)
        a_x = a_l if u > 0 else a_r
        a_l, a_r = fourth_order.states(a, g, 2)
        a_y = a_l if v > 0 else a_r

    axv = ai(a_x, g)
    ayv = ai(a_y, g)

    # face-average -> face-center (transverse Laplacian, MC Eq. 18)
    bufx = (0, 1, 0, 0)
    a_x_cc_w = axv.v(buf=bufx) - 1. / 24 * (axv.jp(-1, buf=bufx) -
                                            2 * axv.v(buf=bufx) +
                                            axv.jp(1, buf=bufx))
    bufy = (0, 0, 0, 1)
    a_y_cc_w = ayv.v(buf=bufy) - 1. / 24 * (ayv.ip(-1, buf=bufy) -
                                            2 * ayv.v(buf=bufy) +
                                            ayv.ip(1, buf=bufy))

    # face-center flux -> face-average flux (MC Eqs. 19-20)
    F_x_avg = ai(u * a_x, g)
    F_y_avg = ai(v * a_y, g)

    F_x_w = u * a_x_cc_w + 1. / 24 * (F_x_avg.jp(-1, buf=bufx) -
                                      2 * F_x_avg.v(buf=bufx) +
                                      F_x_avg.jp(1, buf=bufx))
    F_y_w = v * a_y_cc_w + 1. / 24 * (F_y_avg.ip(-1, buf=bufy) -
                                      2 * F_y_avg.v(buf=bufy) +
                                      F_y_avg.ip(1, buf=bufy))

    return embed(F_x_w, g, bufx), embed(F_y_w, g, bufy)
