#!/usr/bin/env python3
"""Compare Gaussian-diffusion outputs against the self-similar analytic
solution (the port of pyro2_tpu/analysis/gauss_diffusion_compare.py).

    python -m pyro2_tpu_torch.analysis.gauss_diffusion_compare \\
        [--device cpu] file.h5 ...
"""

import argparse

import numpy as np

from pyro2_tpu_torch.analysis import add_device_argument, as_numpy, read
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.solvers.diffusion.problems.gaussian import phi_analytic

usage = """
      usage: python -m pyro2_tpu_torch.analysis.gauss_diffusion_compare \\
                 [--device DEV] file...
"""


def l2_error(myd):
    """L2 error of phi against the analytic Gaussian at the output's t."""
    g = myd.grid
    k = myd.get_aux("k")
    t_0 = myd.get_aux("t_0")
    phi_0 = myd.get_aux("phi_0")
    phi_max = myd.get_aux("phi_max")

    xctr = 0.5 * (g.xmin + g.xmax)
    yctr = 0.5 * (g.ymin + g.ymax)
    dist = np.sqrt((g.x2d - xctr) ** 2 + (g.y2d - yctr) ** 2)
    exact = phi_analytic(dist, myd.t, t_0, k, phi_0, phi_max)

    num = as_numpy(ai(myd.get_var("phi"), g).v())
    e = num - exact[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]
    return np.sqrt(g.dx * g.dy * np.sum(e ** 2))


def main(argv=None):
    ap = argparse.ArgumentParser(usage=usage)
    ap.add_argument("files", nargs="+")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    for fname in args.files:
        myd = read(fname, args.device).cc_data
        l2 = l2_error(myd)
        print(f"{fname}: t = {myd.t:.5g}, N = {myd.grid.nx}, L2 error = "
              f"{l2}")


if __name__ == "__main__":
    main()
