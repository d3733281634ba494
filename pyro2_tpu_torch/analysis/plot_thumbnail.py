#!/usr/bin/env python3
"""Render a tiny borderless thumbnail (128x128 px) of one variable from an
output file (the port of pyro2_tpu/analysis/plot_thumbnail.py).

usage: python -m pyro2_tpu_torch.analysis.plot_thumbnail [--device cpu] \\
           file variable [out.png]
"""

import argparse

from pyro2_tpu_torch.analysis import add_device_argument, as_numpy, read

usage = __doc__


def field(myd, variable):
    """The variable's interior as a numpy array."""
    g = myd.grid
    var = as_numpy(myd.get_var(variable))
    return var[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]


def makeplot(myd, variable, outfile="plot.png"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g = myd.grid
    plt.figure(num=1, figsize=(1.28, 1.28), dpi=100, facecolor="w")
    plt.imshow(field(myd, variable).T,
               interpolation="nearest", origin="lower",
               extent=[g.xmin, g.xmax, g.ymin, g.ymax])
    plt.axis("off")
    plt.subplots_adjust(bottom=0.0, top=1.0, left=0.0, right=1.0)
    plt.savefig(outfile)
    print(f"wrote {outfile}")


def main(argv=None):
    p = argparse.ArgumentParser(usage=usage)
    p.add_argument("file")
    p.add_argument("variable")
    p.add_argument("outfile", nargs="?", default="plot.png")
    add_device_argument(p)
    args = p.parse_args(argv)
    sim = read(args.file, args.device)
    myd = sim.cc_data if hasattr(sim, "cc_data") else sim
    makeplot(myd, args.variable, args.outfile)


if __name__ == "__main__":
    main()
