#!/usr/bin/env python3
"""Exact Riemann solver for the 1-D Euler equations (Toro Ch. 4); the port
of pyro2_tpu/analysis/exact_riemann.py, numpy alone.

Used to generate the exact Sod-tube profile that sod_compare.py checks
against (the reference ships a pre-generated table; this module generates
it).  Its main() reads no output, so it takes no --device.

    python -m pyro2_tpu_torch.analysis.exact_riemann
"""

import numpy as np


def exact_riemann(rho_l, u_l, p_l, rho_r, u_r, p_r, gamma=1.4,
                  t=0.2, x0=0.5, x=None):
    """Sample the exact solution at positions x and time t.

    Returns (x, rho, u, p, e)."""
    if x is None:
        x = np.linspace(0, 1, 256)

    c_l = np.sqrt(gamma * p_l / rho_l)
    c_r = np.sqrt(gamma * p_r / rho_r)

    gm1 = gamma - 1.0
    gp1 = gamma + 1.0

    def f_side(p, ps, rhos, cs):
        """Toro's f_K(p) and its derivative."""
        A = 2.0 / (gp1 * rhos)
        B = gm1 / gp1 * ps
        if p > ps:   # shock
            sq = np.sqrt(A / (p + B))
            return (p - ps) * sq, sq * (1.0 - 0.5 * (p - ps) / (p + B))
        # rarefaction
        pr = (p / ps) ** (gm1 / (2 * gamma))
        return ((2.0 * cs / gm1) * (pr - 1.0),
                (1.0 / (rhos * cs)) * (p / ps) ** (-gp1 / (2 * gamma)))

    # Newton iteration for pstar
    p = max(1.e-8, 0.5 * (p_l + p_r))
    for _ in range(60):
        fl, dfl = f_side(p, p_l, rho_l, c_l)
        fr, dfr = f_side(p, p_r, rho_r, c_r)
        f = fl + fr + (u_r - u_l)
        df = dfl + dfr
        dp = -f / df
        p = max(1.e-10, p + dp)
        if abs(dp) < 1.e-14 * p:
            break
    pstar = p
    fl, _ = f_side(pstar, p_l, rho_l, c_l)
    fr, _ = f_side(pstar, p_r, rho_r, c_r)
    ustar = 0.5 * (u_l + u_r) + 0.5 * (fr - fl)

    xi = (x - x0) / t
    rho = np.zeros_like(x)
    u = np.zeros_like(x)
    pp = np.zeros_like(x)

    for i, s in enumerate(xi):
        if s <= ustar:
            # left of contact
            if pstar > p_l:   # left shock
                rho_star = rho_l * ((pstar / p_l + gm1 / gp1) /
                                    (gm1 / gp1 * pstar / p_l + 1.0))
                S_l = u_l - c_l * np.sqrt(gp1 / (2 * gamma) * pstar / p_l +
                                          gm1 / (2 * gamma))
                if s <= S_l:
                    rho[i], u[i], pp[i] = rho_l, u_l, p_l
                else:
                    rho[i], u[i], pp[i] = rho_star, ustar, pstar
            else:             # left rarefaction
                rho_star = rho_l * (pstar / p_l) ** (1.0 / gamma)
                c_star = c_l * (pstar / p_l) ** (gm1 / (2 * gamma))
                if s <= u_l - c_l:
                    rho[i], u[i], pp[i] = rho_l, u_l, p_l
                elif s >= ustar - c_star:
                    rho[i], u[i], pp[i] = rho_star, ustar, pstar
                else:        # inside the fan
                    u[i] = 2.0 / gp1 * (c_l + gm1 / 2.0 * u_l + s)
                    c = c_l - gm1 / 2.0 * (u[i] - u_l)
                    rho[i] = rho_l * (c / c_l) ** (2.0 / gm1)
                    pp[i] = p_l * (c / c_l) ** (2.0 * gamma / gm1)
        else:
            # right of contact
            if pstar > p_r:   # right shock
                rho_star = rho_r * ((pstar / p_r + gm1 / gp1) /
                                    (gm1 / gp1 * pstar / p_r + 1.0))
                S_r = u_r + c_r * np.sqrt(gp1 / (2 * gamma) * pstar / p_r +
                                          gm1 / (2 * gamma))
                if s >= S_r:
                    rho[i], u[i], pp[i] = rho_r, u_r, p_r
                else:
                    rho[i], u[i], pp[i] = rho_star, ustar, pstar
            else:             # right rarefaction
                rho_star = rho_r * (pstar / p_r) ** (1.0 / gamma)
                c_star = c_r * (pstar / p_r) ** (gm1 / (2 * gamma))
                if s >= u_r + c_r:
                    rho[i], u[i], pp[i] = rho_r, u_r, p_r
                elif s <= ustar + c_star:
                    rho[i], u[i], pp[i] = rho_star, ustar, pstar
                else:
                    u[i] = 2.0 / gp1 * (-c_r + gm1 / 2.0 * u_r + s)
                    c = c_r + gm1 / 2.0 * (u[i] - u_r)
                    rho[i] = rho_r * (c / c_r) ** (2.0 / gm1)
                    pp[i] = p_r * (c / c_r) ** (2.0 * gamma / gm1)

    e = pp / (gm1 * rho)
    return x, rho, u, pp, e


def sod_exact(t=0.2, n=256, gamma=1.4):
    """The standard Sod tube exact profile at time t."""
    x = (np.arange(n) + 0.5) / n
    return exact_riemann(1.0, 0.0, 1.0, 0.125, 0.0, 0.1, gamma=gamma,
                         t=t, x0=0.5, x=x)


def main():
    x, rho, u, p, e = sod_exact()
    print("#        x               rho             u               p"
          "                e")
    for vals in zip(x, rho, u, p, e):
        print("  ".join(f"{v:14.6f}" for v in vals))


if __name__ == "__main__":
    main()
