#!/usr/bin/env python3
"""Error of an incompressible_viscous converge-problem output against the
decaying traveling-wave analytic solution (the port of
pyro2_tpu/analysis/incomp_viscous_converge_error.py).

    python -m pyro2_tpu_torch.analysis.incomp_viscous_converge_error \\
        [--device cpu] file.h5
"""

import argparse
import math

import numpy as np

from pyro2_tpu_torch.analysis import add_device_argument, as_numpy, read
from pyro2_tpu_torch.mesh.indexer import ai

usage = """
      usage: python -m \\
                 pyro2_tpu_torch.analysis.incomp_viscous_converge_error \\
                 [--device DEV] file
"""


def get_errors(filename, device=None):
    """Return (u L2 error, v L2 error) against the analytic solution."""
    myd = read(filename, device).cc_data
    g = myd.grid
    t = myd.t
    nu = myd.get_aux("viscosity")

    decay = np.exp(-8.0 * math.pi ** 2 * nu * t)
    u_exact = (1.0 - 2.0 * np.cos(2.0 * math.pi * (g.x2d - t)) *
               np.sin(2.0 * math.pi * (g.y2d - t)) * decay)
    v_exact = (1.0 + 2.0 * np.sin(2.0 * math.pi * (g.x2d - t)) *
               np.cos(2.0 * math.pi * (g.y2d - t)) * decay)

    errors = []
    for name, exact in (("x-velocity", u_exact), ("y-velocity", v_exact)):
        num = as_numpy(ai(myd.get_var(name), g).v())
        e = num - exact[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]
        errors.append(float(np.sqrt(g.dx * g.dy * np.sum(e ** 2))))
    return tuple(errors)


def main(argv=None):
    ap = argparse.ArgumentParser(usage=usage)
    ap.add_argument("file")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    eu, ev = get_errors(args.file, args.device)
    print("errors: ", eu, ev)


if __name__ == "__main__":
    main()
