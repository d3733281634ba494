#!/usr/bin/env python3
"""Error of a smooth-advection output against the (periodic-translated)
initial Gaussian (the port of pyro2_tpu/analysis/smooth_error.py).

    python -m pyro2_tpu_torch.analysis.smooth_error [--device cpu] file.h5
"""

import argparse

import numpy as np

from pyro2_tpu_torch.analysis import add_device_argument, as_numpy, read
from pyro2_tpu_torch.mesh.indexer import ai

usage = """
      usage: python -m pyro2_tpu_torch.analysis.smooth_error \\
                 [--device DEV] file
      (assumes u = v = 1 and an integer number of periods)
"""


def smooth_error(myd):
    """(nx, L2 error) of the density against the initial Gaussian."""
    g = myd.grid
    xctr = 0.5 * (g.xmin + g.xmax)
    yctr = 0.5 * (g.ymin + g.ymax)
    exact = 1.0 + np.exp(-60.0 * ((g.x2d - xctr) ** 2 +
                                  (g.y2d - yctr) ** 2))

    dens = as_numpy(ai(myd.get_var("density"), g).v())
    e = dens - exact[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]
    return g.nx, np.sqrt(g.dx * g.dy * np.sum(e ** 2))


def main(argv=None):
    p = argparse.ArgumentParser(usage=usage)
    p.add_argument("file")
    add_device_argument(p)
    args = p.parse_args(argv)

    nx, l2 = smooth_error(read(args.file, args.device).cc_data)
    print(f"{nx} {l2}")


if __name__ == "__main__":
    main()
