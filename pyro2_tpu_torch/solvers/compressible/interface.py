"""Characteristic tracing and artificial viscosity on tensors.

The port of pyro2_tpu/solvers/compressible/interface.py, Cartesian and
spherical geometry.  The per-cell 4x4 eigen-system of `states` is unrolled
analytically into closed-form tensor expressions.

Variable layout: stacks are (nvar, qx, qy) with primitive ordering
(rho, u, v, p[, X...]).
"""

import torch

from pyro2_tpu_torch.mesh.indexer import ai, embed

__all__ = ["states", "artificial_viscosity"]


def _win(a, g, buf=2):
    return ai(a, g).v(buf=buf)


def states(idir, g, dxa, dloga, dt, ivars, gamma, qv, dqv):
    """Predict cell-centered primitive states to edges along one dimension.

    Characteristic tracing (Colella 1990): reference states limited by the
    fastest wave toward each face, plus the sum of carried characteristic
    corrections sum_m beta_m r_m.  dxa is the cell width along idir, a
    scalar (Cartesian) or a (qx, qy) tensor (Lx or Ly); dloga is the
    geometric source, a scalar 0 (Cartesian: skipped) or a (qx, qy) tensor
    (dlogAx or dlogAy), which only rho and p pick up.  Returns (q_l, q_r)
    full stacks; q_l[i] is the left state at the i-1/2 interface."""
    irho, iu, iv, ip = ivars.irho, ivars.iu, ivars.iv, ivars.ip
    nq = ivars.nq

    b = 2
    q = _win(qv, g, b)          # (nq, win_x, win_y)
    dq = _win(dqv, g, b)

    if isinstance(dxa, torch.Tensor):
        dtdx = dt / _win(dxa, g, b)
    else:
        dtdx = dt / dxa
    dtdx4 = 0.25 * dtdx

    rho = q[irho]
    p = q[ip]
    cs = torch.sqrt(gamma * p / rho)
    un = q[iu] if idir == 1 else q[iv]

    # eigenvalues: un-c, un, un, un+c (species ride at un)
    ev0 = un - cs
    ev3 = un + cs

    d_rho = dq[irho]
    d_un = dq[iu] if idir == 1 else dq[iv]
    d_ut = dq[iv] if idir == 1 else dq[iu]
    d_p = dq[ip]

    # left-eigenvector dot products l_m . dq (analytic forms)
    a0 = -0.5 * rho / cs * d_un + 0.5 / cs ** 2 * d_p   # l(un-c) . dq
    a1 = d_rho - d_p / cs ** 2                           # l(un)   . dq
    a2 = d_ut                                            # transverse
    a3 = 0.5 * rho / cs * d_un + 0.5 / cs ** 2 * d_p     # l(un+c) . dq

    # beta_m = dtdx/4 (ev_ref - ev_m) (sign gate) (l_m . dq).  The gate is
    # copysign(1, ev) +/- 1, so a stationary wave (ev == 0) gates fully
    # left: test ev >= 0, never sign(ev)
    def beta_pair(ev_m, asum):
        pos = ev_m >= 0.0
        gate_l = torch.where(pos, 2.0, 0.0)
        gate_r = torch.where(pos, 0.0, 2.0)
        bl = dtdx4 * (ev3 - ev_m) * gate_l * asum
        br = dtdx4 * (ev0 - ev_m) * gate_r * asum
        return bl, br

    bl0, br0 = beta_pair(ev0, a0)
    bl1, br1 = beta_pair(un, a1)
    bl2, br2 = beta_pair(un, a2)
    bl3, br3 = beta_pair(ev3, a3)

    # reference states
    factor_l = 0.5 * (1.0 - dtdx * ev3.clamp_min(0.0))
    factor_r = 0.5 * (1.0 + dtdx * ev0.clamp_max(0.0))

    # characteristic corrections: sum_k beta_k rvec[k, m]
    iun = iu if idir == 1 else iv
    iut = iv if idir == 1 else iu

    corr_l = [None] * nq
    corr_r = [None] * nq
    corr_l[irho] = bl0 + bl1 + bl3
    corr_r[irho] = br0 + br1 + br3
    corr_l[iun] = (cs / rho) * (bl3 - bl0)
    corr_r[iun] = (cs / rho) * (br3 - br0)
    corr_l[iut] = bl2
    corr_r[iut] = br2
    corr_l[ip] = cs ** 2 * (bl0 + bl3)
    corr_r[ip] = cs ** 2 * (br0 + br3)

    # species characteristics: beta for ev=un with asum = dq[species]
    for n in range(ivars.ix, ivars.ix + ivars.naux):
        corr_l[n], corr_r[n] = beta_pair(un, dq[n])

    q_l_win = q + factor_l[None] * dq + torch.stack(corr_l)
    q_r_win = q - factor_r[None] * dq + torch.stack(corr_r)

    # geometric source (spherical): only rho and p pick it up
    if isinstance(dloga, torch.Tensor):
        rho_source = -0.5 * dt * _win(dloga, g, b) * rho * un
        for qw in (q_l_win, q_r_win):
            qw[irho] += rho_source
            qw[ip] += rho_source * cs ** 2

    # q_l shifted +1 toward the interface it feeds
    ish, jsh = (1, 0) if idir == 1 else (0, 1)
    return embed(q_l_win, g, b, ish, jsh), embed(q_r_win, g, b)


def artificial_viscosity(g, cvisc, u, v, edges=(1, 1, 1, 1)):
    """Colella-Woodward artificial viscosity coefficients (avisco_x/y).

    Vertex-centered div(U) (Cartesian, or spherical from the r and
    sin(theta) lines of the grid) averaged to faces; avisco = cvisc *
    max(-divU*L, 0).

    `edges` holds the domain-edge flags (xl, xr, yl, yr): 1 where this
    grid's edge is the domain's boundary.  With all four 1 (a serial
    grid) the coefficients are those of the plain interior window, zero
    elsewhere: no viscosity on the domain's outermost high faces.  A block
    of a sharded run has 0 on the edges that are seams: the divergence is
    then taken on the buf=2 window, the coefficients on the (2, 1) window
    the fluxes read them on, and zeroed only outside the global interior
    window, so a seam's high face gets its viscosity from the halo, as the
    same face of the serial grid does (the JAX package's edges)."""
    uv = ai(u, g)
    vv = ai(v, g)
    spherical = getattr(g, "coord_type", 0) == 1
    serial = all(e == 1 for e in edges)

    b = 1 if serial else 2
    ur = 0.5 * (uv.v(buf=b) + uv.jp(-1, buf=b))
    ul = 0.5 * (uv.ip(-1, buf=b) + uv.ip_jp(-1, -1, buf=b))
    vt = 0.5 * (vv.v(buf=b) + vv.ip(-1, buf=b))
    vb = 0.5 * (vv.jp(-1, buf=b) + vv.ip_jp(-1, -1, buf=b))
    if spherical:
        rc, rr, rl, sinc, sint, sinb = (
            _win(p, g, b) for p in sph_planes(g, u))
        ux = (ur * rr ** 2 - ul * rl ** 2) / (rc ** 2 * g.dx)
        vy_raw = (sint * vt - sinb * vb) / (
            rc * torch.where(sinc == 0.0, 1.0, sinc) * g.dy)
        divU_w = ux + torch.where(sinc == 0.0, 0.0, vy_raw)
    else:
        divU_w = (ur - ul) / g.dx + (vt - vb) / g.dy
    dv = ai(embed(divU_w, g, b), g)

    ba = 0 if serial else (2, 1)
    divU_x = 0.5 * (dv.v(buf=ba) + dv.jp(1, buf=ba))
    divU_y = 0.5 * (dv.v(buf=ba) + dv.ip(1, buf=ba))

    if spherical:
        Lx = _win(g.tensor("Lx", u), g, ba)
        Ly = _win(g.tensor("Ly", u), g, ba)
    else:
        Lx, Ly = g.dx, g.dy
    av_x = embed(cvisc * (-divU_x * Lx).clamp_min(0.0), g, ba)
    av_y = embed(cvisc * (-divU_y * Ly).clamp_min(0.0), g, ba)
    if serial:
        return av_x, av_y

    # zero outside the global interior window: a side is clipped only
    # where this grid's edge is the domain's boundary
    xl, xr, yl, yr = edges
    ii = torch.arange(g.qx, device=u.device)[:, None]
    jj = torch.arange(g.qy, device=u.device)[None, :]
    keep = (((ii >= g.ilo) | (xl == 0)) & ((ii <= g.ihi) | (xr == 0)) &
            ((jj >= g.jlo) | (yl == 0)) & ((jj <= g.jhi) | (yr == 0)))
    return torch.where(keep, av_x, 0.0), torch.where(keep, av_y, 0.0)


def sph_planes(g, like):
    """The (qx, qy) planes of the spherical vertex divergence, in `like`'s
    dtype on its device: the node radius r(i-1/2), the centre radii r(i)
    and r(i) - dr, and sin(theta) at the node, the centre and the centre
    below (host float64, rounded once)."""
    def rows(line):
        return torch.as_tensor(line, dtype=like.dtype,
                               device=like.device)[:, None].expand(g.qx, g.qy)

    def lanes(line):
        return torch.as_tensor(line, dtype=like.dtype,
                               device=like.device)[None, :].expand(g.qx, g.qy)

    return (rows(g.xl), rows(g.x), rows(g.x - g.dx),
            lanes(g.sin_yl), lanes(g.sin_y), lanes(g.sin_yb))
