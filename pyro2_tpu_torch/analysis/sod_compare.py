#!/usr/bin/env python3
"""Compare a Sod-tube output against the exact Riemann solution (the port
of pyro2_tpu/analysis/sod_compare.py; the exact profile is generated by
analysis/exact_riemann.py).

    python -m pyro2_tpu_torch.analysis.sod_compare [--device cpu] \\
        file.h5 [plot.png]
"""

import argparse

import numpy as np

from pyro2_tpu_torch.analysis import add_device_argument, as_numpy, read
from pyro2_tpu_torch.analysis.exact_riemann import sod_exact

usage = """
      usage: python -m pyro2_tpu_torch.analysis.sod_compare [--device DEV] \\
                 file [plot.png]
"""


def extract_profile(myd):
    """(coord, rho, un, p, e) 1-D profile along the long direction."""
    myg = myd.grid
    dens = as_numpy(myd.get_var("density"))
    xmom = as_numpy(myd.get_var("x-momentum"))
    ymom = as_numpy(myd.get_var("y-momentum"))
    ener = as_numpy(myd.get_var("energy"))
    gamma = myd.get_aux("gamma")

    if myg.nx > myg.ny:
        jj = myg.ny // 2 + myg.ng
        sl = (slice(myg.ilo, myg.ihi + 1), jj)
        coord = myg.x[myg.ilo:myg.ihi + 1]
        mom = xmom
    else:
        ii = myg.nx // 2 + myg.ng
        sl = (ii, slice(myg.jlo, myg.jhi + 1))
        coord = myg.y[myg.jlo:myg.jhi + 1]
        mom = ymom

    rho = dens[sl]
    un = mom[sl] / rho
    ke = 0.5 * (xmom[sl] ** 2 + ymom[sl] ** 2) / rho
    e = (ener[sl] - ke) / rho
    p = rho * e * (gamma - 1.0)
    return coord, rho, un, p, e


def compare_to_exact(myd):
    """The profile, the exact one at the output's t (512 samples), and
    [(name, mean |err|, max |err|)] of rho, u and p, the exact profile
    interpolated onto the cells."""
    coord, rho, un, p, e = extract_profile(myd)
    gamma = myd.get_aux("gamma")
    exact = sod_exact(t=myd.t, n=512, gamma=gamma)
    xe, rho_e, u_e, p_e, _ = exact
    errors = []
    for name, num, ex in (("rho", rho, np.interp(coord, xe, rho_e)),
                          ("u", un, np.interp(coord, xe, u_e)),
                          ("p", p, np.interp(coord, xe, p_e))):
        errors.append((name, np.abs(num - ex).mean(),
                       np.abs(num - ex).max()))
    return (coord, rho, un, p, e), exact, errors


def main(argv=None):
    ap = argparse.ArgumentParser(usage=usage)
    ap.add_argument("file")
    ap.add_argument("plot", nargs="?", default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    sim = read(args.file, args.device)
    (coord, rho, un, p, e), exact, errors = compare_to_exact(sim.cc_data)
    for name, mean, worst in errors:
        print(f"{name:4s}: mean |err| = {mean:.5g}, "
              f"max |err| = {worst:.5g}")

    if args.plot is not None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        xe, rho_e, u_e, p_e, e_e = exact
        fig, axes = plt.subplots(4, 1, figsize=(6, 10), sharex=True)
        for ax, (name, num, ex) in zip(
                axes, (("rho", rho, rho_e), ("u", un, u_e),
                       ("p", p, p_e), ("e", e, e_e))):
            ax.plot(xe, ex, "k-", lw=1, label="exact")
            ax.plot(coord, num, "bo", ms=2, label="numerical")
            ax.set_ylabel(name)
        axes[0].legend()
        axes[-1].set_xlabel("x")
        fig.savefig(args.plot, dpi=120, bbox_inches="tight")
        print(f"saved {args.plot}")


if __name__ == "__main__":
    main()
