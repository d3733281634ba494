#!/usr/bin/env python3
"""Plot a single variable from an output file to a PNG (the port of
pyro2_tpu/analysis/plotvar.py).

    python -m pyro2_tpu_torch.analysis.plotvar [--device cpu] [--log] \\
        [-o plot.png] file.h5 variable
"""

import argparse

import numpy as np

from pyro2_tpu_torch.analysis import add_device_argument, as_numpy, read
from pyro2_tpu_torch.mesh.indexer import ai


def field(myd, variable, log=False):
    """The variable's interior as a numpy array (log10 of |x| with log)."""
    var = as_numpy(ai(myd.get_var(variable), myd.grid).v())
    if log:
        var = np.log10(np.abs(var))
    return var


def plot(myd, variable, outfile, log=False):
    """Write the variable's interior, with a colorbar, to outfile."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g = myd.grid
    var = field(myd, variable, log)
    plt.figure(figsize=(6, 6 * (g.ymax - g.ymin) / (g.xmax - g.xmin)))
    plt.imshow(var.T, interpolation="nearest", origin="lower",
               extent=[g.xmin, g.xmax, g.ymin, g.ymax], cmap="viridis")
    plt.colorbar()
    plt.xlabel("x")
    plt.ylabel("y")
    plt.title(variable)
    plt.savefig(outfile, dpi=120, bbox_inches="tight")
    print(f"saved {outfile}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--log", action="store_true", help="plot log10 of the var")
    p.add_argument("-o", type=str, default="plot.png", help="output file")
    p.add_argument("plotfile", type=str)
    p.add_argument("variable", type=str)
    add_device_argument(p)
    args = p.parse_args(argv)

    sim = read(args.plotfile, args.device)
    myd = sim.cc_data if hasattr(sim, "cc_data") else sim
    plot(myd, args.variable, args.o, log=args.log)


if __name__ == "__main__":
    main()
