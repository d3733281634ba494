"""Shallow-water characteristic tracing and Riemann solvers on tensors.

The port of pyro2_tpu/solvers/swe/interface.py: the 3x3 eigen-system of
the SWE primitive Jacobian unrolled analytically, and the Roe solver (with
its entropy fix) and HLLC as `torch.where` ladders over whole interface
arrays.  Stacks are (nvar, qx, qy); primitive order (h, u, v[, X...]),
conserved order (h, hu, hv[, hX...]).

The Riemann solvers take the solid-wall flags and ignore them, as the JAX
package's (and the reference's) do: no face is clamped.
"""

import torch

from pyro2_tpu_torch.mesh.indexer import ai, embed

__all__ = ["states", "riemann_roe", "riemann_hllc", "consFlux"]

SMALLC = 1.e-10


def states(idir, g, dx, dt, ivars, grav, qv, dqv):
    """Predict primitive states (h, u, v[, X]) to edges along idir.

    Returns (q_l, q_r) full stacks, zero outside the buf=2 window; q_l[i]
    is the left state at the i-1/2 interface (embedded shifted by +1 along
    idir)."""
    ih, iu, iv = ivars.ih, ivars.iu, ivars.iv

    b = 2
    q = ai(qv, g).v(buf=b)
    dq = ai(dqv, g).v(buf=b)

    dtdx = dt / dx
    dtdx3 = 0.33333 * dtdx   # the reference's (approximate) 1/3 factor

    h = q[ih]
    cs = torch.sqrt(grav * h)
    un = q[iu] if idir == 1 else q[iv]

    d_h = dq[ih]
    d_un = dq[iu] if idir == 1 else dq[iv]
    d_ut = dq[iv] if idir == 1 else dq[iu]

    ev0 = un - cs
    ev2 = un + cs

    # left-eigenvector dot products.  The JAX package assigns a2 twice;
    # the second assignment, l2 . dq = -(cs d_h + h d_un) 0.5/(cs h),
    # is the one that holds
    a0 = 0.5 / (cs * h) * (cs * d_h - h * d_un)
    a1 = d_ut
    a2 = -0.5 / (cs * h) * (cs * d_h + h * d_un)

    # the gate tests ev >= 0 (copysign semantics): a stationary wave gates
    # fully left
    def beta_pair(ev_m, asum):
        pos = ev_m >= 0.0
        gate_l = torch.where(pos, 2.0, 0.0)
        gate_r = torch.where(pos, 0.0, 2.0)
        bl = dtdx3 * (ev2 - ev_m) * gate_l * asum
        br = dtdx3 * (ev0 - ev_m) * gate_r * asum
        return bl, br

    bl0, br0 = beta_pair(ev0, a0)
    bl1, br1 = beta_pair(un, a1)
    bl2, br2 = beta_pair(ev2, a2)

    factor_l = 0.5 * (1.0 - dtdx * ev2.clamp_min(0.0))
    factor_r = 0.5 * (1.0 + dtdx * ev0.clamp_max(0.0))

    q_l_win = q + factor_l[None] * dq
    q_r_win = q - factor_r[None] * dq

    # right eigenvectors: r0 = (h, -c, 0), r_trans = (0,..,1,..),
    # r2 = (h, c, 0)
    corr = {
        ih: (bl0 + bl2, br0 + br2, h),
        (iu if idir == 1 else iv): (bl2 - bl0, br2 - br0, cs),
        (iv if idir == 1 else iu): (bl1, br1, 1.0),
    }
    rows_l = [q_l_win[m] for m in range(ivars.nq)]
    rows_r = [q_r_win[m] for m in range(ivars.nq)]
    for m, (cl, cr, scale) in corr.items():
        rows_l[m] = rows_l[m] + scale * cl
        rows_r[m] = rows_r[m] + scale * cr

    for n in range(ivars.ix, ivars.ix + ivars.naux):
        bls, brs = beta_pair(un, dq[n])
        rows_l[n] = rows_l[n] + bls
        rows_r[n] = rows_r[n] + brs

    ish, jsh = (1, 0) if idir == 1 else (0, 1)
    q_l = embed(torch.stack(rows_l), g, b, ish, jsh)
    q_r = embed(torch.stack(rows_r), g, b)
    return q_l, q_r


def _consFlux_win(idir, grav, ivars, U):
    """SWE analytic flux of a window stack (no h == 0 guard)."""
    h = U[ivars.ih]
    u = U[ivars.ixmom] / h
    v = U[ivars.iymom] / h
    vel = u if idir == 1 else v
    rows = [None] * ivars.nvar
    rows[ivars.ih] = h * vel
    rows[ivars.ixmom] = U[ivars.ixmom] * vel
    rows[ivars.iymom] = U[ivars.iymom] * vel
    if idir == 1:
        rows[ivars.ixmom] = rows[ivars.ixmom] + 0.5 * grav * h ** 2
    else:
        rows[ivars.iymom] = rows[ivars.iymom] + 0.5 * grav * h ** 2
    for n in range(ivars.ihx, ivars.ihx + ivars.naux):
        rows[n] = U[n] * vel
    return torch.stack(rows)


def consFlux(idir, grav, ivars, U_state):
    """SWE analytic flux of a full stack (guarding h == 0 zones)."""
    h = U_state[ivars.ih]
    nonzero = h != 0.0
    rows = [U_state[n] for n in range(ivars.nvar)]
    rows[ivars.ih] = torch.where(nonzero, h, 1.0)
    F = _consFlux_win(idir, grav, ivars, torch.stack(rows))
    return torch.where(nonzero[None], F, 0.0)


def _window(U_l, U_r, g):
    """The interfaces both solvers compute: [ilo-1, ihi+1] on each axis."""
    return ai(U_l, g).v(buf=1), ai(U_r, g).v(buf=1)


def riemann_roe(idir, g, ivars, lower_solid, upper_solid, grav, U_l, U_r):
    """Roe solver with entropy fix (Toro SWE book / clawpack form).

    Returns the interface flux, zero outside [ilo-1, ihi+1]^2."""
    del lower_solid, upper_solid
    Ul, Ur = _window(U_l, U_r, g)

    tol = 0.1e-1   # entropy-fix parameter (assumes cfl ~ 0.1, per reference)

    h_l = Ul[ivars.ih]
    h_r = Ur[ivars.ih]
    iun = ivars.ixmom if idir == 1 else ivars.iymom
    iut = ivars.iymom if idir == 1 else ivars.ixmom
    un_l = Ul[iun] / h_l
    un_r = Ur[iun] / h_r

    c_l = torch.sqrt(grav * h_l).clamp_min(SMALLC)
    c_r = torch.sqrt(grav * h_r).clamp_min(SMALLC)

    # Roe averages (of the velocity components; h is the geometric mean)
    sq_l = torch.sqrt(h_l)
    sq_r = torch.sqrt(h_r)
    U_roe = (Ul / sq_l[None] + Ur / sq_r[None]) / (sq_l + sq_r)[None]
    rows = [U_roe[n] for n in range(ivars.nvar)]
    rows[ivars.ih] = torch.sqrt(h_l * h_r)
    U_roe = torch.stack(rows)
    c_roe = torch.sqrt(0.5 * (c_l ** 2 + c_r ** 2))

    delta = Ur / h_r[None] - Ul / h_l[None]
    rows = [delta[n] for n in range(ivars.nvar)]
    rows[ivars.ih] = h_r - h_l
    delta = torch.stack(rows)

    un_roe = U_roe[iun]
    h_roe = U_roe[ivars.ih]

    lam0 = un_roe - c_roe
    lam1 = un_roe
    lam2 = un_roe + c_roe

    alpha0 = 0.5 * (delta[ivars.ih] - h_roe / c_roe * delta[iun])
    alpha1 = h_roe * delta[iut]
    alpha2 = 0.5 * (delta[ivars.ih] + h_roe / c_roe * delta[iun])

    # entropy fix: widen transonic rarefactions
    h_star = 1.0 / grav * (0.5 * (c_l + c_r) + 0.25 * (un_l - un_r)) ** 2
    u_star = 0.5 * (un_l + un_r) + c_l - c_r
    c_star = torch.sqrt(grav * h_star)

    lam0 = torch.where(lam0.abs() < tol,
                       lam0 * (u_star - c_star - lam0) /
                       (u_star - c_star - (un_l - c_l)), lam0)
    lam2 = torch.where(lam2.abs() < tol,
                       lam2 * (u_star + c_star - lam2) /
                       (u_star + c_star - (un_r + c_r)), lam2)

    F_w = 0.5 * (_consFlux_win(idir, grav, ivars, Ul) +
                 _consFlux_win(idir, grav, ivars, Ur))

    # subtract sum_m 0.5 alpha_m |lam_m| K_m
    # K0 = (1, un-c | ut), K1 = transverse unit, K2 = (1, un+c | ut)
    ut_roe = U_roe[iut]

    def K_contrib(alpha, lam, comp_h, comp_un, comp_ut):
        term = 0.5 * alpha * lam.abs()
        zero = torch.zeros_like(term)
        rows = [zero] * ivars.nvar
        rows[ivars.ih] = term * comp_h
        rows[iun] = term * comp_un
        rows[iut] = term * comp_ut
        return torch.stack(rows)

    F_w = F_w - K_contrib(alpha0, lam0, 1.0, un_roe - c_roe, ut_roe)
    F_w = F_w - K_contrib(alpha1, lam1, 0.0, 0.0, 1.0)
    F_w = F_w - K_contrib(alpha2, lam2, 1.0, un_roe + c_roe, ut_roe)

    # species ride at un_roe with alpha = h_roe * delta
    if ivars.naux > 0:
        rows = [F_w[n] for n in range(ivars.nvar)]
        for n in range(ivars.ihx, ivars.ihx + ivars.naux):
            rows[n] = rows[n] + (-0.5 * h_roe * delta[n] * lam1.abs())
        F_w = torch.stack(rows)

    return embed(F_w, g, 1)


def riemann_hllc(idir, g, ivars, lower_solid, upper_solid, grav, U_l, U_r):
    """HLLC for SWE (Toro); returns the interface flux, zero outside
    [ilo-1, ihi+1]^2."""
    del lower_solid, upper_solid
    Ul, Ur = _window(U_l, U_r, g)

    h_l = Ul[ivars.ih]
    h_r = Ur[ivars.ih]
    iun = ivars.ixmom if idir == 1 else ivars.iymom
    iut = ivars.iymom if idir == 1 else ivars.ixmom
    un_l = Ul[iun] / h_l
    ut_l = Ul[iut] / h_l
    un_r = Ur[iun] / h_r
    ut_r = Ur[iut] / h_r

    c_l = torch.sqrt(grav * h_l).clamp_min(SMALLC)
    c_r = torch.sqrt(grav * h_r).clamp_min(SMALLC)

    h_avg = 0.5 * (h_l + h_r)
    c_avg = 0.5 * (c_l + c_r)
    hstar = h_avg - 0.25 * (un_r - un_l) * h_avg / c_avg

    S_l = torch.where(hstar <= h_l, un_l - c_l,
                      un_l - c_l * torch.sqrt(0.5 * (hstar + h_l) * hstar) /
                      h_l)
    S_r = torch.where(hstar <= h_r, un_r + c_r,
                      un_r + c_r * torch.sqrt(0.5 * (hstar + h_r) * hstar) /
                      h_r)
    S_c = (S_l * h_r * (un_r - S_r) - S_r * h_l * (un_l - S_l)) / \
        (h_r * (un_r - S_r) - h_l * (un_l - S_l))

    F_l = _consFlux_win(idir, grav, ivars, Ul)
    F_r = _consFlux_win(idir, grav, ivars, Ur)

    def star_state(U, h, un, ut, S):
        fac = h * (S - un) / (S - S_c)
        rows = [None] * ivars.nvar
        rows[ivars.ih] = fac
        rows[iun] = fac * S_c
        rows[iut] = fac * ut
        for n in range(ivars.ihx, ivars.ihx + ivars.naux):
            rows[n] = fac * U[n] / h
        return torch.stack(rows)

    F_star_r = F_r + S_r[None] * (star_state(Ur, h_r, un_r, ut_r, S_r) - Ur)
    F_star_l = F_l + S_l[None] * (star_state(Ul, h_l, un_l, ut_l, S_l) - Ul)

    # the region select, in the JAX package's nesting order
    Sl_b, Sr_b, Sc_b = S_l[None], S_r[None], S_c[None]
    F_w = torch.where(Sr_b <= 0.0, F_r,
                      torch.where((Sc_b <= 0.0) & (Sr_b > 0.0), F_star_r,
                                  torch.where((Sl_b < 0.0) & (Sc_b > 0.0),
                                              F_star_l, F_l)))

    return embed(F_w, g, 1)
