"""The plain reference of the configuration compressible.quad.

What the program computes for this configuration, as plain PyTorch on
whole frames: the quadrant problem's initial data, the outflow ghost
fill, the CFL timestep with the driver's ladder, and the CTU step of the
flagship solver (flattening, 4th-order MC slopes, characteristic tracing,
the transverse corrections from a first HLLC pair, the final HLLC pair,
Colella-Woodward artificial viscosity, the conservative update).  It is a
frozen copy of the program's plain composition for this configuration
(solvers/compressible/simulation.py `plain_step`, unsplit_fluxes.py,
interface.py, riemann.py, mesh/reconstruction.py, mesh/indexer.py), in
the same order of operations, with the branches this configuration never
takes left out: grav = 0 (no source terms), no density floor, no sponge,
Cartesian geometry.  It imports nothing of the program.

Frames are (4, nx + 8, ny + 8) stacks in the conserved order density,
energy, x-momentum, y-momentum; x is axis 1.
"""

import numpy as np
import torch
import torch.nn.functional as F

NAME = "compressible.quad"
# the numbers the comparison reads (benchmark/harness/checks.py)
NUMBERS = ("start_gap", "step_gap", "dt_gap")
NG = 4
IDENS, IENER, IXMOM, IYMOM = 0, 1, 2, 3     # conserved
IRHO, IU, IV, IP = 0, 1, 2, 3               # primitive
SMALLC = SMALLRHO = SMALLP = 1.e-10


class Grid:
    """The interior bounds, spacing and cell centres of the domain."""

    def __init__(self, p):
        self.nx, self.ny = int(p["mesh.nx"]), int(p["mesh.ny"])
        self.qx, self.qy = self.nx + 2 * NG, self.ny + 2 * NG
        self.ilo, self.ihi = NG, NG + self.nx - 1
        self.jlo, self.jhi = NG, NG + self.ny - 1
        xmin, xmax = float(p["mesh.xmin"]), float(p["mesh.xmax"])
        ymin, ymax = float(p["mesh.ymin"]), float(p["mesh.ymax"])
        self.dx = (xmax - xmin) / self.nx
        self.dy = (ymax - ymin) / self.ny
        xl = (np.arange(self.qx) - NG) * self.dx + xmin
        yl = (np.arange(self.qy) - NG) * self.dy + ymin
        self.x = 0.5 * (xl + (xl + self.dx))
        self.y = 0.5 * (yl + (yl + self.dy))


def _split(b):
    if isinstance(b, tuple):
        return b[0], b[1], b[0], b[1]
    return b, b, b, b


def win(a, g, i=0, j=0, buf=0):
    """The interior window of a (..., qx, qy) tensor, widened by buf ghost
    cells (an int or (lo, hi)) and shifted by i cells in x, j in y."""
    bxlo, bxhi, bylo, byhi = _split(buf)
    return a[..., g.ilo - bxlo + i:g.ihi + 1 + bxhi + i,
             g.jlo - bylo + j:g.jhi + 1 + byhi + j]


def embed(vals, g, buf=0, i=0, j=0):
    """A buf-window (shifted by i, j) placed in a zero (..., qx, qy)
    frame."""
    bxlo, bxhi, bylo, byhi = _split(buf)
    lo_x, lo_y = g.ilo - bxlo + i, g.jlo - bylo + j
    hi_x, hi_y = g.ihi + bxhi + i, g.jhi + byhi + j
    return F.pad(vals, (lo_y, g.qy - hi_y - 1, lo_x, g.qx - hi_x - 1))


# ---------------------------------------------------------------------------
# initial data and ghost fill
# ---------------------------------------------------------------------------

def initial(p, dtype, device):
    """The four quadrants' states on the frame, ghosts included, made in
    float64 on the host and rounded once to dtype."""
    g = Grid(p)
    gamma = p["eos.gamma"]
    cx, cy = p["quadrant.cx"], p["quadrant.cy"]
    x2d, y2d = np.meshgrid(g.x, g.y, indexing="ij")
    U = np.zeros((4, g.qx, g.qy))
    quads = {1: (x2d >= cx) & (y2d >= cy), 2: (x2d < cx) & (y2d >= cy),
             3: (x2d < cx) & (y2d < cy), 4: (x2d >= cx) & (y2d < cy)}
    for n, idx in quads.items():
        r = p[f"quadrant.rho{n}"]
        u = p[f"quadrant.u{n}"]
        v = p[f"quadrant.v{n}"]
        pr = p[f"quadrant.p{n}"]
        U[IDENS][idx] = r
        U[IXMOM][idx] = r * u
        U[IYMOM][idx] = r * v
        U[IENER][idx] = pr / (gamma - 1.0) + 0.5 * r * (u * u + v * v)
    return torch.as_tensor(U, dtype=dtype, device=device)


def fill(U, g):
    """Outflow ghosts on every side, in place: x edges, then y edges over
    whole columns (corners included)."""
    U[:, :NG, :] = U[:, NG:NG + 1, :]
    U[:, g.ihi + 1:, :] = U[:, g.ihi:g.ihi + 1, :]
    U[:, :, :NG] = U[:, :, NG:NG + 1]
    U[:, :, g.jhi + 1:] = U[:, :, g.jhi:g.jhi + 1]
    return U


# ---------------------------------------------------------------------------
# the CTU step
# ---------------------------------------------------------------------------

def cons_to_prim(U, gamma):
    rho = U[IDENS]
    nonzero = rho != 0.0
    safe_rho = torch.where(nonzero, rho, 1.0)
    u = torch.where(nonzero, U[IXMOM] / safe_rho, 0.0)
    v = torch.where(nonzero, U[IYMOM] / safe_rho, 0.0)
    e = torch.where(nonzero,
                    (U[IENER] - 0.5 * rho * (u ** 2 + v ** 2)) / safe_rho,
                    0.0)
    return torch.stack([rho, u, v, rho * e * (gamma - 1.0)])


def prim_to_cons(q, gamma):
    rows = [None] * 4
    rows[IDENS] = q[IRHO]
    rows[IXMOM] = q[IU] * q[IRHO]
    rows[IYMOM] = q[IV] * q[IRHO]
    rows[IENER] = q[IP] / (gamma - 1.0) + 0.5 * q[IRHO] * \
        (q[IU] ** 2 + q[IV] ** 2)
    return torch.stack(rows)


def _diffs(a, g, idir):
    if idir == 1:
        return win(a, g, 1, 0, 2), win(a, g, 0, 0, 2), win(a, g, -1, 0, 2)
    return win(a, g, 0, 1, 2), win(a, g, 0, 0, 2), win(a, g, 0, -1, 2)


def _mc(dc, dl, dr):
    d1 = 2.0 * torch.where(dl.abs() < dr.abs(), dl, dr)
    dt = torch.where(dc.abs() < d1.abs(), dc, d1)
    return torch.where(dl * dr > 0.0, dt, 0.0)


def limit2(a, g, idir):
    p, c, m = _diffs(a, g, idir)
    return embed(_mc(0.5 * (p - m), p - c, c - m), g, 2)


def limit4(a, g, idir):
    tp, _, tm = _diffs(limit2(a, g, idir), g, idir)
    p, c, m = _diffs(a, g, idir)
    dc = (2.0 / 3.0) * (p - m - 0.25 * (tp + tm))
    return embed(_mc(dc, p - c, c - m), g, 2)


def flatten(g, q, idir, p):
    """The 1-D flattening coefficient, one outside the buf=2 window."""
    delta, z0, z1 = (p["compressible.delta"], p["compressible.z0"],
                     p["compressible.z1"])
    i, j = (1, 0) if idir == 1 else (0, 1)
    pr = q[IP]
    un = q[IU] if idir == 1 else q[IV]
    dp1 = (win(pr, g, i, j, 2) - win(pr, g, -i, -j, 2)).abs()
    dp2 = (win(pr, g, 2 * i, 2 * j, 2) - win(pr, g, -2 * i, -2 * j, 2)).abs()
    t2_w = dp1 / torch.minimum(win(pr, g, i, j, 2), win(pr, g, -i, -j, 2))
    t1_w = win(un, g, -i, -j, 2) - win(un, g, i, j, 2)
    z = embed(dp1 / dp2.clamp_min(1.0e-10), g, 2)
    t1 = embed(t1_w, g, 2)
    t2 = embed(t2_w, g, 2)
    xi = (1.0 - (z - z0) / (z1 - z0)).clamp_min(0.0).clamp_max(1.0)
    return torch.where((t1 > 0.0) & (t2 > delta), xi, 1.0)


def flatten_multid(g, q, xi_x, xi_y):
    pr = q[IP]
    px = torch.where(win(pr, g, 1, 0, 2) - win(pr, g, -1, 0, 2) > 0,
                     win(xi_x, g, -1, 0, 2), win(xi_x, g, 1, 0, 2))
    py = torch.where(win(pr, g, 0, 1, 2) - win(pr, g, 0, -1, 2) > 0,
                     win(xi_y, g, 0, -1, 2), win(xi_y, g, 0, 1, 2))
    v = torch.minimum(torch.minimum(win(xi_x, g, buf=2), px),
                      torch.minimum(win(xi_y, g, buf=2), py))
    return embed(v, g, 2)


def states(idir, g, dxa, dt, gamma, qv, dqv):
    """Characteristic tracing to the faces along idir: (q_l, q_r), q_l[i]
    the left state of face i - 1/2."""
    q = win(qv, g, buf=2)
    dq = win(dqv, g, buf=2)
    dtdx = dt / dxa
    dtdx4 = 0.25 * dtdx

    rho = q[IRHO]
    cs = torch.sqrt(gamma * q[IP] / rho)
    un = q[IU] if idir == 1 else q[IV]
    ev0 = un - cs
    ev3 = un + cs

    d_un = dq[IU] if idir == 1 else dq[IV]
    d_ut = dq[IV] if idir == 1 else dq[IU]
    d_p = dq[IP]
    a0 = -0.5 * rho / cs * d_un + 0.5 / cs ** 2 * d_p
    a1 = dq[IRHO] - d_p / cs ** 2
    a2 = d_ut
    a3 = 0.5 * rho / cs * d_un + 0.5 / cs ** 2 * d_p

    def beta_pair(ev_m, asum):
        pos = ev_m >= 0.0
        gate_l = torch.where(pos, 2.0, 0.0)
        gate_r = torch.where(pos, 0.0, 2.0)
        return (dtdx4 * (ev3 - ev_m) * gate_l * asum,
                dtdx4 * (ev0 - ev_m) * gate_r * asum)

    bl0, br0 = beta_pair(ev0, a0)
    bl1, br1 = beta_pair(un, a1)
    bl2, br2 = beta_pair(un, a2)
    bl3, br3 = beta_pair(ev3, a3)

    factor_l = 0.5 * (1.0 - dtdx * ev3.clamp_min(0.0))
    factor_r = 0.5 * (1.0 + dtdx * ev0.clamp_max(0.0))

    iun, iut = (IU, IV) if idir == 1 else (IV, IU)
    corr_l = [None] * 4
    corr_r = [None] * 4
    corr_l[IRHO] = bl0 + bl1 + bl3
    corr_r[IRHO] = br0 + br1 + br3
    corr_l[iun] = (cs / rho) * (bl3 - bl0)
    corr_r[iun] = (cs / rho) * (br3 - br0)
    corr_l[iut] = bl2
    corr_r[iut] = br2
    corr_l[IP] = cs ** 2 * (bl0 + bl3)
    corr_r[IP] = cs ** 2 * (br0 + br3)

    q_l = q + factor_l[None] * dq + torch.stack(corr_l)
    q_r = q - factor_r[None] * dq + torch.stack(corr_r)
    i, j = (1, 0) if idir == 1 else (0, 1)
    return embed(q_l, g, 2, i, j), embed(q_r, g, 2)


def interface_states(U, g, p, dt):
    gamma = p["eos.gamma"]
    q = cons_to_prim(U, gamma)
    xi = flatten_multid(g, q, flatten(g, q, 1, p), flatten(g, q, 2, p))
    ldx = torch.stack([xi * limit4(q[n], g, 1) for n in range(4)])
    ldy = torch.stack([xi * limit4(q[n], g, 2) for n in range(4)])
    V_xl, V_xr = states(1, g, g.dx, dt, gamma, q, ldx)
    V_yl, V_yr = states(2, g, g.dy, dt, gamma, q, ldy)
    return tuple(prim_to_cons(V, gamma) for V in (V_xl, V_xr, V_yl, V_yr))


def _decompose(U, idir, gamma):
    rho = U[IDENS]
    if idir == 1:
        un, ut = U[IXMOM] / rho, U[IYMOM] / rho
    else:
        un, ut = U[IYMOM] / rho, U[IXMOM] / rho
    rhoe = U[IENER] - 0.5 * rho * (un ** 2 + ut ** 2)
    return rho, un, ut, (rhoe * (gamma - 1.0)).clamp_min(SMALLP)


def cons_flux(idir, gamma, U):
    rho = U[IDENS]
    nonzero = rho != 0.0
    safe_rho = torch.where(nonzero, rho, 1.0)
    u = torch.where(nonzero, U[IXMOM] / safe_rho, 0.0)
    v = torch.where(nonzero, U[IYMOM] / safe_rho, 0.0)
    pr = (U[IENER] - 0.5 * rho * (u * u + v * v)) * (gamma - 1.0)
    vel = u if idir == 1 else v
    rows = [None] * 4
    rows[IDENS] = rho * vel
    rows[IXMOM] = U[IXMOM] * vel
    rows[IYMOM] = U[IYMOM] * vel
    if idir == 1:
        rows[IXMOM] = rows[IXMOM] + pr
    else:
        rows[IYMOM] = rows[IYMOM] + pr
    rows[IENER] = (U[IENER] + pr) * vel
    return torch.stack(rows)


def wave_speeds(rho_l, u_l, p_l, c_l, rho_r, u_r, p_r, c_r, gamma):
    p_max = torch.maximum(p_l, p_r)
    p_min = torch.minimum(p_l, p_r)
    Q = p_max / p_min
    factor = (0.5 * (rho_l + rho_r)) * (0.5 * (c_l + c_r))
    pstar0 = 0.5 * (p_l + p_r) + 0.5 * (u_l - u_r) * factor

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
    # (gamma + 1) / (2 / gamma), as upstream pyro2 writes it
    S_r = torch.where(
        pstar <= p_r, u_r + c_r,
        u_r + c_r * torch.sqrt(1.0 + ((gamma + 1.0) / (2.0 / gamma)) *
                               (pstar / p_r - 1.0)))
    return S_l, S_r


def hllc(idir, g, gamma, U_l, U_r):
    """The HLLC flux on the buf=1 window, zero outside it."""
    w = (slice(None), slice(g.ilo - 1, g.ihi + 2),
         slice(g.jlo - 1, g.jhi + 2))
    Ul, Ur = U_l[w], U_r[w]
    rho_l, un_l, ut_l, p_l = _decompose(Ul, idir, gamma)
    rho_r, un_r, ut_r, p_r = _decompose(Ur, idir, gamma)
    c_l = torch.sqrt(gamma * p_l / rho_l).clamp_min(SMALLC)
    c_r = torch.sqrt(gamma * p_r / rho_r).clamp_min(SMALLC)
    S_l, S_r = wave_speeds(rho_l, un_l, p_l, c_l, rho_r, un_r, p_r, c_r,
                           gamma)
    S_c = (p_r - p_l + rho_l * un_l * (S_l - un_l) -
           rho_r * un_r * (S_r - un_r)) / \
        (rho_l * (S_l - un_l) - rho_r * (S_r - un_r))

    F_l = cons_flux(idir, gamma, Ul)
    F_r = cons_flux(idir, gamma, Ur)

    def star(U, rho, un, ut, pr, S):
        f = rho * (S - un) / (S - S_c)
        rows = [None] * 4
        rows[IDENS] = f
        if idir == 1:
            rows[IXMOM], rows[IYMOM] = f * S_c, f * ut
        else:
            rows[IXMOM], rows[IYMOM] = f * ut, f * S_c
        rows[IENER] = f * (U[IENER] / rho +
                           (S_c - un) * (S_c + pr / (rho * (S - un))))
        return torch.stack(rows)

    F_star_r = F_r + S_r[None] * (star(Ur, rho_r, un_r, ut_r, p_r, S_r) - Ur)
    F_star_l = F_l + S_l[None] * (star(Ul, rho_l, un_l, ut_l, p_l, S_l) - Ul)
    Sl, Sr, Sc = S_l[None], S_r[None], S_c[None]
    flux = torch.where(Sr <= 0.0, F_r,
                       torch.where((Sc <= 0.0) & (Sr > 0.0), F_star_r,
                                   torch.where((Sl < 0.0) & (Sc > 0.0),
                                               F_star_l, F_l)))
    return embed(flux, g, 1)


def transverse(U_xl, U_xr, U_yl, U_yr, g, gamma, dt):
    """The normal states corrected by the transverse flux differences of
    the first HLLC pair, in place on the (2, 1) window."""
    Fx = hllc(1, g, gamma, U_xl, U_xr)
    Fy = hllc(2, g, gamma, U_yl, U_yr)
    b = (2, 1)
    hdtV = 0.5 * dt / (g.dx * g.dy)
    Ax, Ay = g.dy, g.dx
    win(U_xl, g, buf=b).add_(-hdtV * (win(Fy, g, -1, 1, b) * Ay -
                                      win(Fy, g, -1, 0, b) * Ay))
    win(U_xr, g, buf=b).add_(-hdtV * (win(Fy, g, 0, 1, b) * Ay -
                                      win(Fy, g, 0, 0, b) * Ay))
    win(U_yl, g, buf=b).add_(-hdtV * (win(Fx, g, 1, -1, b) * Ax -
                                      win(Fx, g, 0, -1, b) * Ax))
    win(U_yr, g, buf=b).add_(-hdtV * (win(Fx, g, 1, 0, b) * Ax -
                                      win(Fx, g, 0, 0, b) * Ax))
    return U_xl, U_xr, U_yl, U_yr


def viscosity(F_x, F_y, q, U, g, cvisc):
    """Colella-Woodward artificial viscosity added to the fluxes, in place
    on the (2, 1) window (a serial grid: no viscosity outside the interior
    window)."""
    u, v = q[IU], q[IV]
    ur = 0.5 * (win(u, g, buf=1) + win(u, g, 0, -1, 1))
    ul = 0.5 * (win(u, g, -1, 0, 1) + win(u, g, -1, -1, 1))
    vt = 0.5 * (win(v, g, buf=1) + win(v, g, -1, 0, 1))
    vb = 0.5 * (win(v, g, 0, -1, 1) + win(v, g, -1, -1, 1))
    dv = embed((ur - ul) / g.dx + (vt - vb) / g.dy, g, 1)
    divU_x = 0.5 * (win(dv, g) + win(dv, g, 0, 1))
    divU_y = 0.5 * (win(dv, g) + win(dv, g, 1, 0))
    av_x = embed(cvisc * (-divU_x * g.dx).clamp_min(0.0), g)
    av_y = embed(cvisc * (-divU_y * g.dy).clamp_min(0.0), g)
    b = (2, 1)
    win(F_x, g, buf=b).add_(win(av_x, g, buf=b)[None] *
                            (win(U, g, -1, 0, b) - win(U, g, buf=b)))
    win(F_y, g, buf=b).add_(win(av_y, g, buf=b)[None] *
                            (win(U, g, 0, -1, b) - win(U, g, buf=b)))
    return F_x, F_y


def ctu_step(U, g, p, dt):
    """One CTU step of a ghost-filled frame; the ghosts are carried."""
    gamma = p["eos.gamma"]
    U = U.clone()
    U_xl, U_xr, U_yl, U_yr = interface_states(U, g, p, dt)
    U_xl, U_xr, U_yl, U_yr = transverse(U_xl, U_xr, U_yl, U_yr, g, gamma,
                                        dt)
    F_x = hllc(1, g, gamma, U_xl, U_xr)
    F_y = hllc(2, g, gamma, U_yl, U_yr)
    F_x, F_y = viscosity(F_x, F_y, cons_to_prim(U, gamma), U, g,
                         p["compressible.cvisc"])
    dtdV = dt / (g.dx * g.dy)
    Ax, Ay = g.dy, g.dx
    upd = dtdV * (win(F_x, g) * Ax - win(F_x, g, 1, 0) * Ax +
                  win(F_y, g) * Ay - win(F_y, g, 0, 1) * Ay)
    out = U.clone()
    win(out, g).add_(upd)
    return out


def dt_raw(U, g, gamma):
    """min over the interior of L / (|u| + cs) in x and y (a 0-d
    tensor)."""
    q = cons_to_prim(U, gamma)
    cs = torch.sqrt(gamma * q[IP] / q[IRHO])
    xtmp = win(g.dx / (q[IU].abs() + cs), g)
    ytmp = win(g.dy / (q[IV].abs() + cs), g)
    return torch.minimum(xtmp.min(), ytmp.min())


def check_config(p):
    """Raise unless p is the configuration this reference computes."""
    wanted = {"compressible.riemann": "HLLC", "compressible.limiter": 2,
              "compressible.use_flattening": 1, "compressible.grav": 0.0,
              "sponge.do_sponge": 0, "driver.fix_dt": -1.0,
              "mesh.grid_type": "Cartesian2d"}
    for edge in ("xl", "xr", "yl", "yr"):
        wanted[f"mesh.{edge}boundary"] = "outflow"
    for k, v in wanted.items():
        if p[k] != v:
            raise ValueError(f"the quad reference takes {k} = {v}, "
                             f"not {p[k]}")
    if p["compressible.small_dens"] > -1.e30:
        raise ValueError("the quad reference takes no density floor")


def advance(U, t, n, dt_old, steps, p, device_dt):
    """`steps` steps of the run loop from the frame U (its interior is the
    state): each fills the ghosts, takes the CFL timestep through the
    driver's ladder and makes a CTU step.  With device_dt False the
    timestep is the host loop's (a Python float, from the device's
    minimum), with True the on-device loop's (0-d tensors of U's dtype:
    t, dt_old; n an int tensor).  Returns (U, the last step's dt): on the
    on-device loop the ladder's dt before the tmax clamp, which the loop
    carries as dt_old."""
    check_config(p)
    g = Grid(p)
    gamma, cfl = p["eos.gamma"], p["driver.cfl"]
    factor, change = p["driver.init_tstep_factor"], p["driver.max_dt_change"]
    tmax = p["driver.tmax"]
    dt = None
    for _ in range(steps):
        U = fill(U.clone(), g)
        if device_dt:
            raw = cfl * dt_raw(U, g, gamma)
            raw = torch.where(n == 0, factor * raw,
                              torch.minimum(change * dt_old, raw))
            dt_old = raw
            dt = torch.minimum(raw, tmax - t)
        else:
            dt = cfl * float(dt_raw(U, g, gamma))
            dt = factor * dt if n == 0 else min(change * dt_old, dt)
            dt_old = dt
            if t + dt > tmax:
                dt = tmax - t
        U = ctu_step(U, g, p, dt)
        t = t + dt
        n = n + 1
    return U, float(dt_old if device_dt else dt)


def interior(U, p):
    """The interior window of a frame."""
    return win(U, Grid(p))

