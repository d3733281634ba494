"""4th-order McCorquodale & Colella fluxes on tensors.

The port of pyro2_tpu/solvers/compressible_fv4/fluxes.py: average <->
center conversions with positivity fallbacks, limited 4th-order face states
blended with flattening, a primitive-variable CGF Riemann solve on face
averages, face-average <-> face-center transverse-Laplacian corrections,
and the MC Eq. 35-36 artificial viscosity.
"""

import torch

from pyro2_tpu_torch.mesh import fourth_order, reconstruction
from pyro2_tpu_torch.mesh.fv import to_centers_array
from pyro2_tpu_torch.mesh.indexer import ai, embed
from pyro2_tpu_torch.solvers.compressible import riemann

__all__ = ["flux_cons", "fluxes", "ALPHA", "BETA"]

# MC Eq. 35-36 artificial-viscosity constants
ALPHA = 0.3
BETA = 0.3


def flux_cons(ivars, idir, gamma, q):
    """Analytic conserved flux of a primitive stack."""
    un = q[ivars.iu] if idir == 1 else q[ivars.iv]
    rho = q[ivars.irho]
    p = q[ivars.ip]

    rows = [None] * ivars.nvar
    rows[ivars.idens] = rho * un
    if idir == 1:
        rows[ivars.ixmom] = rho * q[ivars.iu] ** 2 + p
        rows[ivars.iymom] = rho * q[ivars.iv] * q[ivars.iu]
    else:
        rows[ivars.ixmom] = rho * q[ivars.iu] * q[ivars.iv]
        rows[ivars.iymom] = rho * q[ivars.iv] ** 2 + p
    rows[ivars.iener] = (
        (p / (gamma - 1.0) + 0.5 * rho * (q[ivars.iu] ** 2 +
                                          q[ivars.iv] ** 2) + p) * un)
    for nq_i, nu_i in zip(range(ivars.ix, ivars.ix + ivars.naux),
                          range(ivars.irhox, ivars.irhox + ivars.naux)):
        rows[nu_i] = rho * q[nq_i] * un
    return torch.stack(rows)


def _window_mask(g, b, device):
    ii = torch.arange(g.qx, device=device)[:, None]
    jj = torch.arange(g.qy, device=device)[None, :]
    return ((ii >= g.ilo - b) & (ii <= g.ihi + b) &
            (jj >= g.jlo - b) & (jj <= g.jhi + b))


def fluxes(U_avg, myd, rp, ivars):
    """(F_x, F_y) 4th-order face-average fluxes from cell averages."""
    from pyro2_tpu_torch.solvers.compressible import simulation as comp

    myg = myd.grid
    gamma = rp.get_param("eos.gamma")

    # averages -> centers, with a fallback to averages where unphysical
    U_cc = to_centers_array(U_avg, myg)
    rhoe = U_cc[ivars.iener] - 0.5 * (U_cc[ivars.ixmom] ** 2 +
                                      U_cc[ivars.iymom] ** 2) / \
        U_cc[ivars.idens]
    bad = (U_cc[ivars.idens] < 0) | (rhoe < 0)
    U_cc = torch.where(bad[None], U_avg, U_cc)

    q_bar = comp.cons_to_prim(U_avg, gamma, ivars, myg, check=False)
    q_cc = comp.cons_to_prim(U_cc, gamma, ivars, myg, check=False)

    # 4th-order cell-average primitive state on the buf=3 window (zero
    # outside it), with a positivity fallback for rho and p
    qb = ai(q_bar, myg)
    b3 = 3
    q_avg = embed(ai(q_cc, myg).v(buf=b3) +
                  myg.dx ** 2 / 24.0 * qb.lap(buf=b3), myg, b3)
    m3 = _window_mask(myg, b3, U_avg.device)
    for n in (ivars.irho, ivars.ip):
        fixed = torch.where(q_avg[n] > 0, q_avg[n], q_cc[n])
        q_avg[n] = torch.where(m3, fixed, 0.0)

    if rp.get_param("compressible.use_flattening"):
        xi_x = reconstruction.flatten(myg, q_bar, 1, ivars, rp)
        xi_y = reconstruction.flatten(myg, q_bar, 2, ivars, rp)
        xi = reconstruction.flatten_multid(myg, q_bar, xi_x, xi_y, ivars)
    else:
        xi = torch.ones_like(q_bar[0])

    xiv = ai(xi, myg)
    U_avg_v = ai(U_avg, myg)

    out = {}
    for idir in (1, 2):
        # limited 4th-order face states per variable
        pairs = [fourth_order.states(q_avg[n], myg, idir)
                 for n in range(ivars.nq)]
        q_l = torch.stack([p[0] for p in pairs])
        q_r = torch.stack([p[1] for p in pairs])

        # blend toward the unlimited average by the flattening
        # coefficient; the left state at a face takes the coefficient and
        # the average of the cell below it (ip_jp(ish, jsh))
        b = 2
        ish, jsh = (1, 0) if idir == 1 else (0, 1)
        xw = xiv.v(buf=b)[None]
        qa_w = ai(q_avg, myg).v(buf=b)
        blend_l = xw * ai(q_l, myg).ip_jp(ish, jsh, buf=b) + \
            (1.0 - xw) * qa_w
        blend_r = xw * ai(q_r, myg).v(buf=b) + (1.0 - xw) * qa_w
        ai(q_l, myg).ip_jp(ish, jsh, buf=b).copy_(blend_l)
        ai(q_r, myg).v(buf=b).copy_(blend_r)

        # face-average interface state via the primitive Riemann solver
        # (no solid-wall clamps in this solver)
        q_int_avg = riemann.riemann_prim(idir, myg, ivars, 0, 0, gamma,
                                         q_l, q_r)

        # face-average -> face-center (transverse Laplacian)
        qia = ai(q_int_avg, myg)
        bf = myg.ng - 1
        if idir == 1:
            fc_w = qia.v(buf=bf) - 1.0 / 24.0 * (
                qia.jp(1, buf=bf) - 2 * qia.v(buf=bf) + qia.jp(-1, buf=bf))
        else:
            fc_w = qia.v(buf=bf) - 1.0 / 24.0 * (
                qia.ip(1, buf=bf) - 2 * qia.v(buf=bf) + qia.ip(-1, buf=bf))
        q_int_fc = embed(fc_w, myg, bf)

        # final face-average flux (MC Eqs. 33-34)
        Ffc = ai(flux_cons(ivars, idir, gamma, q_int_fc), myg)
        Fav = ai(flux_cons(ivars, idir, gamma, q_int_avg), myg)
        b1 = 1
        if idir == 1:
            F_w = Ffc.v(buf=b1) + 1.0 / 24.0 * (
                Fav.jp(1, buf=b1) - 2 * Fav.v(buf=b1) + Fav.jp(-1, buf=b1))
        else:
            F_w = Ffc.v(buf=b1) + 1.0 / 24.0 * (
                Fav.ip(1, buf=b1) - 2 * Fav.v(buf=b1) + Fav.ip(-1, buf=b1))

        # MC Eq. 35-36 artificial viscosity
        if idir == 1:
            lam_w = ((qb.v(buf=b1)[ivars.iu] -
                      qb.ip(-1, buf=b1)[ivars.iu]) / myg.dx +
                     0.25 * (qb.jp(1, buf=b1)[ivars.iv] -
                             qb.jp(-1, buf=b1)[ivars.iv] +
                             qb.ip_jp(-1, 1, buf=b1)[ivars.iv] -
                             qb.ip_jp(-1, -1, buf=b1)[ivars.iv]) / myg.dy)
        else:
            lam_w = ((qb.v(buf=b1)[ivars.iv] -
                      qb.jp(-1, buf=b1)[ivars.iv]) / myg.dy +
                     0.25 * (qb.ip(1, buf=b1)[ivars.iu] -
                             qb.ip(-1, buf=b1)[ivars.iu] +
                             qb.ip_jp(1, -1, buf=b1)[ivars.iu] -
                             qb.ip_jp(-1, -1, buf=b1)[ivars.iu]) / myg.dx)
        test_w = (myg.dx * lam_w) ** 2 / \
            (BETA * gamma * qb.v(buf=b1)[ivars.ip] /
             qb.v(buf=b1)[ivars.irho])
        nu_w = myg.dx * lam_w * test_w.clamp_max(1.0)
        nu_w = torch.where(lam_w >= 0.0, 0.0, nu_w)

        if idir == 1:
            dU = U_avg_v.v(buf=b1) - U_avg_v.ip(-1, buf=b1)
        else:
            dU = U_avg_v.v(buf=b1) - U_avg_v.jp(-1, buf=b1)
        out[idir] = embed(F_w + ALPHA * nu_w[None] * dU, myg, b1)

    return out[1], out[2]
