"""Riemann solvers for compressible flow on tensors.

The port of pyro2_tpu/solvers/compressible/riemann.py: the shock /
rarefaction region selection is elementwise `torch.where` ladders over
whole interface windows.  Solvers: CGF (Colella-Glaz-Ferguson two-shock
star state), HLLC, and low-Mach-corrected HLLC (Minoshima & Miyoshi 2021).
All operate on (nvar, qx, qy) stacks, are valid on the buf=1 window, and
are zero outside it.
"""

import numpy as np
import torch

from pyro2_tpu_torch.mesh.indexer import embed
from pyro2_tpu_torch.util import msg

__all__ = ["riemann_cgf", "riemann_prim", "estimate_wave_speed",
           "riemann_hllc",
           "riemann_hllc_lowspeed", "riemann_flux", "consFlux"]

SMALLC = 1.e-10
SMALLRHO = 1.e-10
SMALLP = 1.e-10


def _wslice(g, b=1):
    return (slice(g.ilo - b, g.ihi + 2), slice(g.jlo - b, g.jhi + 2))


def _solid_mask(g, idir, lower_solid, upper_solid, shape, device):
    """True where the interface normal velocity must be zeroed (solid
    walls): interfaces ilo / ihi+1 (idir 1) or jlo / jhi+1 (idir 2) on the
    buf=1 window.  None when both walls are open."""
    if lower_solid == 0 and upper_solid == 0:
        return None
    if idir == 1:
        idx = np.arange(g.ilo - 1, g.ihi + 2)
        lo, hi = g.ilo, g.ihi + 1
    else:
        idx = np.arange(g.jlo - 1, g.jhi + 2)
        lo, hi = g.jlo, g.jhi + 1
    line = ((idx == lo) & (lower_solid == 1)) | \
        ((idx == hi) & (upper_solid == 1))
    mask = line[:, None] if idir == 1 else line[None, :]
    return torch.as_tensor(np.broadcast_to(mask, shape).copy(),
                           device=device)


def _decompose(U, idir, ivars, gamma):
    """Window stack -> (rho, un, ut, rhoe, p) with pressure floors."""
    rho = U[ivars.idens]
    if idir == 1:
        un = U[ivars.ixmom] / rho
        ut = U[ivars.iymom] / rho
    else:
        un = U[ivars.iymom] / rho
        ut = U[ivars.ixmom] / rho
    rhoe = U[ivars.iener] - 0.5 * rho * (un ** 2 + ut ** 2)
    p = (rhoe * (gamma - 1.0)).clamp_min(SMALLP)
    return rho, un, ut, rhoe, p


def _cgf_core(idir, g, lower_solid, upper_solid, gamma,
              rho_l, un_l, ut_l, rhoe_l, p_l,
              rho_r, un_r, ut_r, rhoe_r, p_r):
    """The CGF star-state construction + wave-region resolution.

    Returns (rho, un, ut, p, rhoe, ustar) interface states on the window."""
    W_l = torch.sqrt(gamma * p_l * rho_l).clamp_min(SMALLRHO * SMALLC)
    W_r = torch.sqrt(gamma * p_r * rho_r).clamp_min(SMALLRHO * SMALLC)

    c_l = torch.sqrt(gamma * p_l / rho_l).clamp_min(SMALLC)
    c_r = torch.sqrt(gamma * p_r / rho_r).clamp_min(SMALLC)

    pstar = ((W_l * p_r + W_r * p_l + W_l * W_r * (un_l - un_r)) /
             (W_l + W_r)).clamp_min(SMALLP)
    ustar = (W_l * un_l + W_r * un_r + (p_l - p_r)) / (W_l + W_r)

    rhostar_l = rho_l + (pstar - p_l) / c_l ** 2
    rhostar_r = rho_r + (pstar - p_r) / c_r ** 2

    rhoestar_l = rhoe_l + (pstar - p_l) * (rhoe_l / rho_l +
                                           p_l / rho_l) / c_l ** 2
    rhoestar_r = rhoe_r + (pstar - p_r) * (rhoe_r / rho_r +
                                           p_r / rho_r) / c_r ** 2

    cstar_l = torch.sqrt(gamma * pstar / rhostar_l).clamp_min(SMALLC)
    cstar_r = torch.sqrt(gamma * pstar / rhostar_r).clamp_min(SMALLC)

    def resolve(outer, star, lam, lamstar, p_s, left):
        """Per-quantity wave-region select for one side of the contact."""
        sigma = 0.5 * (lam + lamstar)
        if left:
            shock = torch.where(sigma > 0.0, outer, star)
        else:
            shock = torch.where(sigma > 0.0, star, outer)
        denom = lam - lamstar
        alpha = lam / torch.where(denom == 0.0, 1.0, denom)
        interp = alpha * star + (1.0 - alpha) * outer
        both_neg = (lam < 0.0) & (lamstar < 0.0)
        both_pos = (lam > 0.0) & (lamstar > 0.0)
        if left:
            raref = torch.where(both_neg, star,
                                torch.where(both_pos, outer, interp))
        else:
            raref = torch.where(both_neg, outer,
                                torch.where(both_pos, star, interp))
        return torch.where(pstar > p_s, shock, raref)

    lam_l = un_l - c_l
    lamstar_l = ustar - cstar_l
    lam_r = un_r + c_r
    lamstar_r = ustar + cstar_r

    def pick(q_l_outer, q_l_star, q_r_outer, q_r_star, mid):
        Ls = resolve(q_l_outer, q_l_star, lam_l, lamstar_l, p_l, True)
        Rs = resolve(q_r_outer, q_r_star, lam_r, lamstar_r, p_r, False)
        return torch.where(ustar > 0.0, Ls,
                           torch.where(ustar < 0.0, Rs, mid))

    rho_state = pick(rho_l, rhostar_l, rho_r, rhostar_r,
                     0.5 * (rhostar_l + rhostar_r))
    un_state = pick(un_l, ustar, un_r, ustar, ustar)
    p_state = pick(p_l, pstar, p_r, pstar, pstar)
    rhoe_state = pick(rhoe_l, rhoestar_l, rhoe_r, rhoestar_r,
                      0.5 * (rhoestar_l + rhoestar_r))
    ut_state = torch.where(ustar > 0.0, ut_l,
                           torch.where(ustar < 0.0, ut_r,
                                       0.5 * (ut_l + ut_r)))

    # solid-wall clamp on the normal velocity
    solid = _solid_mask(g, idir, lower_solid, upper_solid, rho_state.shape,
                        rho_state.device)
    if solid is not None:
        un_state = torch.where(solid, 0.0, un_state)

    return rho_state, un_state, ut_state, p_state, rhoe_state, ustar


def riemann_cgf(idir, g, ivars, lower_solid, upper_solid, gamma, U_l, U_r):
    """CGF solver on conserved states; returns the interface conserved
    state U."""
    w = _wslice(g)
    Ul = U_l[(slice(None),) + w]
    Ur = U_r[(slice(None),) + w]

    rho_l, un_l, ut_l, rhoe_l, p_l = _decompose(Ul, idir, ivars, gamma)
    rho_r, un_r, ut_r, rhoe_r, p_r = _decompose(Ur, idir, ivars, gamma)

    rho_s, un_s, ut_s, _p_s, rhoe_s, ustar = _cgf_core(
        idir, g, lower_solid, upper_solid, gamma,
        rho_l, un_l, ut_l, rhoe_l, p_l, rho_r, un_r, ut_r, rhoe_r, p_r)

    rows = [None] * ivars.nvar
    rows[ivars.idens] = rho_s
    if idir == 1:
        rows[ivars.ixmom] = rho_s * un_s
        rows[ivars.iymom] = rho_s * ut_s
    else:
        rows[ivars.ixmom] = rho_s * ut_s
        rows[ivars.iymom] = rho_s * un_s
    rows[ivars.iener] = rhoe_s + 0.5 * rho_s * (un_s ** 2 + ut_s ** 2)

    # species ride with the contact
    for n in range(ivars.irhox, ivars.irhox + ivars.naux):
        xn_l = Ul[n] / Ul[ivars.idens]
        xn_r = Ur[n] / Ur[ivars.idens]
        xn = torch.where(ustar > 0.0, xn_l,
                         torch.where(ustar < 0.0, xn_r,
                                     0.5 * (xn_l + xn_r)))
        rows[n] = xn * rho_s

    return embed(torch.stack(rows), g, 1)


def riemann_prim(idir, g, ivars, lower_solid, upper_solid, gamma, q_l, q_r):
    """CGF solver on primitive states; returns the primitive interface
    state, valid on the buf=1 window (the 4th-order solver's)."""
    w = _wslice(g)
    ql = q_l[(slice(None),) + w]
    qr = q_r[(slice(None),) + w]

    rho_l = ql[ivars.irho]
    rho_r = qr[ivars.irho]
    if idir == 1:
        un_l, ut_l = ql[ivars.iu], ql[ivars.iv]
        un_r, ut_r = qr[ivars.iu], qr[ivars.iv]
    else:
        un_l, ut_l = ql[ivars.iv], ql[ivars.iu]
        un_r, ut_r = qr[ivars.iv], qr[ivars.iu]
    p_l = ql[ivars.ip].clamp_min(SMALLP)
    p_r = qr[ivars.ip].clamp_min(SMALLP)
    rhoe_l = p_l / (gamma - 1.0)
    rhoe_r = p_r / (gamma - 1.0)

    rho_s, un_s, ut_s, p_s, _rhoe_s, ustar = _cgf_core(
        idir, g, lower_solid, upper_solid, gamma,
        rho_l, un_l, ut_l, rhoe_l, p_l, rho_r, un_r, ut_r, rhoe_r, p_r)

    rows = [None] * ivars.nq
    rows[ivars.irho] = rho_s
    if idir == 1:
        rows[ivars.iu] = un_s
        rows[ivars.iv] = ut_s
    else:
        rows[ivars.iu] = ut_s
        rows[ivars.iv] = un_s
    rows[ivars.ip] = p_s

    # species ride with the contact
    for n in range(ivars.ix, ivars.ix + ivars.naux):
        rows[n] = torch.where(ustar > 0.0, ql[n],
                              torch.where(ustar < 0.0, qr[n],
                                          0.5 * (ql[n] + qr[n])))

    return embed(torch.stack(rows), g, 1)


def estimate_wave_speed(rho_l, u_l, p_l, c_l, rho_r, u_r, p_r, c_r, gamma):
    """(S_l, S_r) wave-speed estimates with 2-shock/2-rarefaction
    upgrades when the simple primitive solver is unreliable."""
    p_max = torch.maximum(p_l, p_r)
    p_min = torch.minimum(p_l, p_r)
    Q = p_max / p_min

    rho_avg = 0.5 * (rho_l + rho_r)
    c_avg = 0.5 * (c_l + c_r)
    factor = rho_avg * c_avg

    pstar0 = 0.5 * (p_l + p_r) + 0.5 * (u_l - u_r) * factor

    # 2-rarefaction estimate
    z = (gamma - 1.0) / (2.0 * gamma)
    p_lr = (p_l / p_r) ** z
    ustar_2r = (p_lr * u_l / c_l + u_r / c_r +
                2.0 * (p_lr - 1.0) / (gamma - 1.0)) / \
        (p_lr / c_l + 1.0 / c_r)
    pstar_2r = 0.5 * (
        p_l * (1.0 + (gamma - 1.0) * (u_l - ustar_2r) / (2.0 * c_l))
        ** (1.0 / z) +
        p_r * (1.0 + (gamma - 1.0) * (ustar_2r - u_r) / (2.0 * c_r))
        ** (1.0 / z))

    # 2-shock estimate
    A_r = 2.0 / ((gamma + 1.0) * rho_r)
    B_r = p_r * (gamma - 1.0) / (gamma + 1.0)
    A_l = 2.0 / ((gamma + 1.0) * rho_l)
    B_l = p_l * (gamma - 1.0) / (gamma + 1.0)
    p_guess = pstar0.clamp_min(0.0)
    g_l = torch.sqrt(A_l / (p_guess + B_l))
    g_r = torch.sqrt(A_r / (p_guess + B_r))
    pstar_2s = (g_l * p_l + g_r * p_r - (u_r - u_l)) / (g_l + g_r)

    upgrade = (Q > 2.0) & ((pstar0 < p_min) | (pstar0 > p_max))
    use_2r = upgrade & (pstar0 < p_min)
    use_2s = upgrade & ~(pstar0 < p_min)

    pstar = torch.where(use_2r, pstar_2r,
                        torch.where(use_2s, pstar_2s, pstar0))

    S_l = torch.where(
        pstar <= p_l, u_l - c_l,
        u_l - c_l * torch.sqrt(1.0 + ((gamma + 1.0) / (2.0 * gamma)) *
                               (pstar / p_l - 1.0)))
    # (gamma + 1) / (2 / gamma) here, not / (2 gamma): kept as the JAX
    # package and upstream pyro2 write it, for trajectory parity
    S_r = torch.where(
        pstar <= p_r, u_r + c_r,
        u_r + c_r * torch.sqrt(1.0 + ((gamma + 1.0) / (2.0 / gamma)) *
                               (pstar / p_r - 1.0)))
    return S_l, S_r


def consFlux(idir, coord_type, gamma, ivars, U):
    """Analytic conserved flux of a stack.  Pressure joins the
    normal-momentum flux only in Cartesian geometry."""
    rho = U[ivars.idens]
    nonzero = rho != 0.0
    safe_rho = torch.where(nonzero, rho, 1.0)
    u = torch.where(nonzero, U[ivars.ixmom] / safe_rho, 0.0)
    v = torch.where(nonzero, U[ivars.iymom] / safe_rho, 0.0)
    p = (U[ivars.iener] - 0.5 * rho * (u * u + v * v)) * (gamma - 1.0)

    vel = u if idir == 1 else v
    rows = [None] * ivars.nvar
    rows[ivars.idens] = rho * vel
    rows[ivars.ixmom] = U[ivars.ixmom] * vel
    rows[ivars.iymom] = U[ivars.iymom] * vel
    if coord_type == 0:
        if idir == 1:
            rows[ivars.ixmom] = rows[ivars.ixmom] + p
        else:
            rows[ivars.iymom] = rows[ivars.iymom] + p
    rows[ivars.iener] = (U[ivars.iener] + p) * vel
    for n in range(ivars.irhox, ivars.irhox + ivars.naux):
        rows[n] = U[n] * vel
    return torch.stack(rows)


def _hllc_shared(idir, ivars, gamma, Ul, Ur):
    """Shared HLLC preamble: primitive decomposition + wave speeds."""
    rho_l, un_l, ut_l, _rhoe_l, p_l = _decompose(Ul, idir, ivars, gamma)
    rho_r, un_r, ut_r, _rhoe_r, p_r = _decompose(Ur, idir, ivars, gamma)

    c_l = torch.sqrt(gamma * p_l / rho_l).clamp_min(SMALLC)
    c_r = torch.sqrt(gamma * p_r / rho_r).clamp_min(SMALLC)

    S_l, S_r = estimate_wave_speed(rho_l, un_l, p_l, c_l,
                                   rho_r, un_r, p_r, c_r, gamma)

    # contact speed from Rankine-Hugoniot (Batten et al. 1997)
    S_c = (p_r - p_l + rho_l * un_l * (S_l - un_l) -
           rho_r * un_r * (S_r - un_r)) / \
        (rho_l * (S_l - un_l) - rho_r * (S_r - un_r))

    return (rho_l, un_l, ut_l, p_l, rho_r, un_r, ut_r, p_r,
            c_l, c_r, S_l, S_r, S_c)


def _hllc_select(S_l, S_r, S_c, F_l, F_r, F_star_l, F_star_r):
    Sl_b = S_l[None]
    Sr_b = S_r[None]
    Sc_b = S_c[None]
    return torch.where(Sr_b <= 0.0, F_r,
                       torch.where((Sc_b <= 0.0) & (Sr_b > 0.0), F_star_r,
                                   torch.where((Sl_b < 0.0) & (Sc_b > 0.0),
                                               F_star_l, F_l)))


def riemann_hllc(idir, g, ivars, lower_solid, upper_solid, gamma, U_l, U_r):
    """HLLC solver (Toro); returns the interface flux.  Solid walls are
    ignored, as in the JAX package."""
    del lower_solid, upper_solid
    w = _wslice(g)
    Ul = U_l[(slice(None),) + w]
    Ur = U_r[(slice(None),) + w]

    (rho_l, un_l, ut_l, p_l, rho_r, un_r, ut_r, p_r,
     _c_l, _c_r, S_l, S_r, S_c) = _hllc_shared(idir, ivars, gamma, Ul, Ur)

    F_l = consFlux(idir, 0, gamma, ivars, Ul)
    F_r = consFlux(idir, 0, gamma, ivars, Ur)

    def star_state(U, rho, un, ut, p, S):
        """The HLLC star-region conserved state for one side."""
        HLLCfactor = rho * (S - un) / (S - S_c)
        rows = [None] * ivars.nvar
        rows[ivars.idens] = HLLCfactor
        if idir == 1:
            rows[ivars.ixmom] = HLLCfactor * S_c
            rows[ivars.iymom] = HLLCfactor * ut
        else:
            rows[ivars.ixmom] = HLLCfactor * ut
            rows[ivars.iymom] = HLLCfactor * S_c
        rows[ivars.iener] = HLLCfactor * (
            U[ivars.iener] / rho +
            (S_c - un) * (S_c + p / (rho * (S - un))))
        for n in range(ivars.irhox, ivars.irhox + ivars.naux):
            rows[n] = HLLCfactor * U[n] / rho
        return torch.stack(rows)

    Ustar_r = star_state(Ur, rho_r, un_r, ut_r, p_r, S_r)
    Ustar_l = star_state(Ul, rho_l, un_l, ut_l, p_l, S_l)

    F_star_r = F_r + S_r[None] * (Ustar_r - Ur)
    F_star_l = F_l + S_l[None] * (Ustar_l - Ul)

    return embed(_hllc_select(S_l, S_r, S_c, F_l, F_r, F_star_l, F_star_r),
                 g, 1)


def riemann_hllc_lowspeed(idir, g, ivars, lower_solid, upper_solid,
                          gamma, U_l, U_r):
    """HLLC in Toro's alternate form with the Minoshima & Miyoshi (2021)
    low-Mach pressure fix; returns the interface flux."""
    del lower_solid, upper_solid
    w = _wslice(g)
    Ul = U_l[(slice(None),) + w]
    Ur = U_r[(slice(None),) + w]

    (rho_l, un_l, ut_l, p_l, rho_r, un_r, ut_r, p_r,
     c_l, c_r, S_l, S_r, S_c) = _hllc_shared(idir, ivars, gamma, Ul, Ur)

    iun = ivars.ixmom if idir == 1 else ivars.iymom

    F_l = consFlux(idir, 0, gamma, ivars, Ul)
    F_r = consFlux(idir, 0, gamma, ivars, Ur)

    # low-Mach-corrected star pressure
    vmag_l = torch.sqrt(un_l ** 2 + ut_l ** 2)
    vmag_r = torch.sqrt(un_r ** 2 + ut_r ** 2)
    cs_max = torch.maximum(c_l, c_r)
    chi = (torch.maximum(vmag_l, vmag_r) / cs_max).clamp_max(1.0)
    phi = chi * (2.0 - chi)
    pstar_lr = 0.5 * (p_l + p_r) + \
        0.5 * phi * (rho_l * (S_l - un_l) * (S_c - un_l) +
                     rho_r * (S_r - un_r) * (S_c - un_r))

    def star_flux(U, F, S):
        rows = list(S_c[None] * (S[None] * U - F))
        rows[iun] = rows[iun] + S * pstar_lr
        rows[ivars.iener] = rows[ivars.iener] + S * pstar_lr * S_c
        return torch.stack(rows) / (S - S_c)[None]

    F_star_r = star_flux(Ur, F_r, S_r)
    F_star_l = star_flux(Ul, F_l, S_l)

    return embed(_hllc_select(S_l, S_r, S_c, F_l, F_r, F_star_l, F_star_r),
                 g, 1)


SOLVERS = {"HLLC": riemann_hllc,
           "HLLC_lm": riemann_hllc_lowspeed,
           "CGF": riemann_cgf}


def riemann_flux(idir, U_l, U_r, my_data, rp, ivars,
                 lower_solid, upper_solid, tc, return_cons=False):
    """Dispatch on compressible.riemann and assemble the interface flux
    (CGF gives the interface state, whose flux is taken here, without the
    pressure term in spherical geometry).  With return_cons, CGF returns
    (flux, interface state); the HLLC solvers have no interface state and
    return the flux alone, as in the JAX package."""
    tm_riem = tc.timer("riemann")
    tm_riem.begin()

    myg = my_data.grid
    riemann_method = rp.get_param("compressible.riemann")
    gamma = rp.get_param("eos.gamma")

    if riemann_method not in SOLVERS:
        msg.fail("ERROR: Riemann solver undefined")

    _u = SOLVERS[riemann_method](idir, myg, ivars,
                                 lower_solid, upper_solid, gamma, U_l, U_r)

    if riemann_method != "CGF":
        tm_riem.end()
        return _u
    _f = consFlux(idir, getattr(myg, "coord_type", 0), gamma, ivars, _u)

    tm_riem.end()
    if return_cons:
        return _f, _u
    return _f
