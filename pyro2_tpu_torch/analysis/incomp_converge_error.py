#!/usr/bin/env python3
"""Error of an incompressible converge-problem output against the Minion
(1996) analytic traveling solution (the port of
pyro2_tpu/analysis/incomp_converge_error.py).

    python -m pyro2_tpu_torch.analysis.incomp_converge_error \\
        [--device cpu] file.h5
"""

import argparse
import math

import numpy as np

from pyro2_tpu_torch.analysis import add_device_argument, as_numpy, read
from pyro2_tpu_torch.mesh.indexer import ai

usage = """
      usage: python -m pyro2_tpu_torch.analysis.incomp_converge_error \\
                 [--device DEV] file
"""


def errors(myd):
    """[(name, L2 error)] of the x and y velocities at the output's t."""
    g = myd.grid
    t = myd.t

    u_exact = (1.0 - 2.0 * np.cos(2.0 * math.pi * (g.x2d - t)) *
               np.sin(2.0 * math.pi * (g.y2d - t)))
    v_exact = (1.0 + 2.0 * np.sin(2.0 * math.pi * (g.x2d - t)) *
               np.cos(2.0 * math.pi * (g.y2d - t)))

    out = []
    for name, exact in (("x-velocity", u_exact), ("y-velocity", v_exact)):
        num = as_numpy(ai(myd.get_var(name), g).v())
        e = num - exact[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]
        out.append((name, np.sqrt(g.dx * g.dy * np.sum(e ** 2))))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(usage=usage)
    ap.add_argument("file")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    myd = read(args.file, args.device).cc_data
    for name, l2 in errors(myd):
        print(f"{name}: N = {myd.grid.nx}, L2 error = {l2}")


if __name__ == "__main__":
    main()
