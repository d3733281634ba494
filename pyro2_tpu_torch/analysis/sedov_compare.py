#!/usr/bin/env python3
"""Radially average a Sedov output and (optionally) compare to an exact
cylindrical Sedov profile table (the port of
pyro2_tpu/analysis/sedov_compare.py).

The exact table has columns (r/r_shock, rho/rho_shock, u/u_shock,
p/p_shock); pass one (e.g. the published cylindrical-sedov solution) as the
second argument to difference against it.

    python -m pyro2_tpu_torch.analysis.sedov_compare [--device cpu] \\
        file.h5 [exact_table]
"""

import argparse

import numpy as np

from pyro2_tpu_torch.analysis import add_device_argument, as_numpy, read
from pyro2_tpu_torch.solvers.compressible import Variables, cons_to_prim

usage = """
      usage: python -m pyro2_tpu_torch.analysis.sedov_compare \\
                 [--device DEV] file [exact_table]
"""


def radial_profile(myd):
    """(r_bin_centers, rho(r), u_r(r), p(r)) by radial binning."""
    g = myd.grid
    ivars = Variables(myd)
    gamma = myd.get_aux("gamma")
    q = as_numpy(cons_to_prim(myd.data, gamma, ivars, g))

    xctr = 0.5 * (g.xmin + g.xmax)
    yctr = 0.5 * (g.ymin + g.ymax)

    sl = (slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
    x = g.x2d[sl] - xctr
    y = g.y2d[sl] - yctr
    r = np.sqrt(x ** 2 + y ** 2).ravel()

    rho = q[ivars.irho][sl].ravel()
    u = q[ivars.iu][sl].ravel()
    v = q[ivars.iv][sl].ravel()
    p = q[ivars.ip][sl].ravel()
    ur = np.where(r > 0, (u * x.ravel() + v * y.ravel()) /
                  np.where(r > 0, r, 1.0), 0.0)

    nbins = g.nx // 2
    r_max = r.max()
    idx = np.minimum((r / r_max * nbins).astype(int), nbins - 1)
    counts = np.bincount(idx, minlength=nbins)
    counts = np.where(counts == 0, 1, counts)

    def binavg(f):
        return np.bincount(idx, weights=f, minlength=nbins) / counts

    r_bins = (np.arange(nbins) + 0.5) * r_max / nbins
    return r_bins, binavg(rho), binavg(ur), binavg(p)


def inside_shock_error(r, rho, exact):
    """Mean |rho - exact| inside the shock, the table's (r/r_shock,
    rho/rho_shock) scaled by the profile's peak."""
    i_shock = int(np.argmax(rho))
    r_s = r[i_shock]
    scaled_r = r / r_s
    rho_e = np.interp(scaled_r, exact[:, 0], exact[:, 1] * rho[i_shock])
    ok = scaled_r <= 1.0
    return np.abs(rho[ok] - rho_e[ok]).mean()


def main(argv=None):
    ap = argparse.ArgumentParser(usage=usage)
    ap.add_argument("file")
    ap.add_argument("exact_table", nargs="?", default=None)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    sim = read(args.file, args.device)
    r, rho, ur, p = radial_profile(sim.cc_data)

    i_shock = int(np.argmax(rho))
    print(f"shock radius ~ {r[i_shock]:.4f}, peak rho = {rho.max():.4f}, "
          f"peak p = {p.max():.4f}")

    if args.exact_table is not None:
        err = inside_shock_error(r, rho, np.loadtxt(args.exact_table))
        print(f"mean |rho err| inside shock = {err:.5g}")
    else:
        for rr, dd, uu, pp in zip(r, rho, ur, p):
            print(f"{rr:12.6f} {dd:12.6f} {uu:12.6f} {pp:12.6f}")


if __name__ == "__main__":
    main()
