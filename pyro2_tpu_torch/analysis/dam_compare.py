#!/usr/bin/env python3
"""Compare a dam-break output against the exact shallow-water solution
(wet-bed dam break; the port of pyro2_tpu/analysis/dam_compare.py).

    python -m pyro2_tpu_torch.analysis.dam_compare [--device cpu] \\
        file.h5 [plot.png]
"""

import argparse

import numpy as np
from scipy.optimize import brentq

from pyro2_tpu_torch.analysis import add_device_argument, as_numpy, read

usage = """
      usage: python -m pyro2_tpu_torch.analysis.dam_compare [--device DEV] \\
                 file [plot.png]
"""


def dam_exact(h_l, h_r, g, t, x0, x):
    """Exact wet-bed dam-break profile (Stoker solution)."""
    c_l = np.sqrt(g * h_l)
    c_r = np.sqrt(g * h_r)

    # solve for the star-region depth via the shock condition
    def f(h_m):
        c_m = np.sqrt(g * h_m)
        u_m = 2.0 * (c_l - c_m)
        # shock speed from mass conservation
        S = h_m * u_m / (h_m - h_r)
        # momentum jump condition residual
        return S * (h_m * u_m) - (h_m * u_m ** 2 + 0.5 * g * h_m ** 2 -
                                  0.5 * g * h_r ** 2)

    h_m = brentq(f, h_r * (1 + 1e-9), h_l * (1 - 1e-9))
    c_m = np.sqrt(g * h_m)
    u_m = 2.0 * (c_l - c_m)
    S = h_m * u_m / (h_m - h_r)

    xi = (x - x0) / t
    h = np.where(xi <= -c_l, h_l,
                 np.where(xi <= u_m - c_m,
                          (2.0 * c_l - xi) ** 2 / (9.0 * g),
                          np.where(xi <= S, h_m, h_r)))
    u = np.where(xi <= -c_l, 0.0,
                 np.where(xi <= u_m - c_m, 2.0 / 3.0 * (xi + c_l),
                          np.where(xi <= S, u_m, 0.0)))
    return h, u


def compare_to_exact(myd):
    """(coord, h, u, h_exact, u_exact) along the break's direction, through
    the middle of the other, the exact profile from the extreme heights of
    the output at its t."""
    myg = myd.grid
    h2d = as_numpy(myd.get_var("height"))
    xmom = as_numpy(myd.get_var("x-momentum"))
    ymom = as_numpy(myd.get_var("y-momentum"))
    g_const = myd.get_aux("g")

    if myg.nx > myg.ny:
        jj = myg.ny // 2 + myg.ng
        sl = (slice(myg.ilo, myg.ihi + 1), jj)
        coord = myg.x[myg.ilo:myg.ihi + 1]
        x0 = 0.5 * (myg.xmin + myg.xmax)
        mom = xmom
    else:
        ii = myg.nx // 2 + myg.ng
        sl = (ii, slice(myg.jlo, myg.jhi + 1))
        coord = myg.y[myg.jlo:myg.jhi + 1]
        x0 = 0.5 * (myg.ymin + myg.ymax)
        mom = ymom

    h = h2d[sl]
    u = mom[sl] / h

    h_l = h.max()
    h_r = h.min()
    h_e, u_e = dam_exact(h_l, h_r, g_const, myd.t, x0, coord)
    return coord, h, u, h_e, u_e


def main(argv=None):
    ap = argparse.ArgumentParser(usage=usage)
    ap.add_argument("file")
    ap.add_argument("plot", nargs="?", default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    sim = read(args.file, args.device)
    coord, h, u, h_e, u_e = compare_to_exact(sim.cc_data)

    print(f"h: mean |err| = {np.abs(h - h_e).mean():.5g}, "
          f"max |err| = {np.abs(h - h_e).max():.5g}")
    print(f"u: mean |err| = {np.abs(u - u_e).mean():.5g}, "
          f"max |err| = {np.abs(u - u_e).max():.5g}")

    if args.plot is not None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(2, 1, sharex=True)
        axes[0].plot(coord, h_e, "k-", label="exact")
        axes[0].plot(coord, h, "bo", ms=2, label="numerical")
        axes[0].set_ylabel("h")
        axes[0].legend()
        axes[1].plot(coord, u_e, "k-")
        axes[1].plot(coord, u, "bo", ms=2)
        axes[1].set_ylabel("u")
        fig.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"saved {args.plot}")


if __name__ == "__main__":
    main()
