#!/usr/bin/env python3
"""Compact (axis-free) plot of one variable from an output file; the
pseudo-variable "vort" plots the centered-difference vorticity (the port of
pyro2_tpu/analysis/plotcompact.py).

usage: python -m pyro2_tpu_torch.analysis.plotcompact [--device cpu] \\
           [-m vmin] [-M vmax] plotfile variable outfile
"""

import argparse

from pyro2_tpu_torch.analysis import add_device_argument, as_numpy, read
from pyro2_tpu_torch.mesh.indexer import ai


def field(myd, variable):
    """The variable's interior as a numpy array; "vort" is the centred
    vorticity of the x- and y-velocity, differenced on the device."""
    g = myd.grid
    if variable == "vort":
        vx = ai(myd.get_var("x-velocity"), g)
        vy = ai(myd.get_var("y-velocity"), g)
        v = (0.5 * (vy.ip(1) - vy.ip(-1)) / g.dx -
             0.5 * (vx.jp(1) - vx.jp(-1)) / g.dy)
        return as_numpy(v)
    return as_numpy(ai(myd.get_var(variable), g).v())


def makeplot(plotfile, variable, outfile, vmin=None, vmax=None,
             device=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sim = read(plotfile, device)
    myd = sim.cc_data if hasattr(sim, "cc_data") else sim
    g = myd.grid
    v = field(myd, variable)

    if vmin is None:
        vmin = v.min()
    if vmax is None:
        vmax = v.max()

    plt.figure(num=1, figsize=(6.5, 6.5), dpi=100, facecolor="w")
    plt.imshow(v.T, interpolation="nearest", origin="lower",
               extent=[g.xmin, g.xmax, g.ymin, g.ymax],
               vmin=vmin, vmax=vmax)
    plt.axis("off")
    plt.subplots_adjust(bottom=0.0, top=1.0, left=0.0, right=1.0)
    plt.savefig(outfile)
    print(f"wrote {outfile}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", type=float, default=None, help="vmin")
    p.add_argument("-M", type=float, default=None, help="vmax")
    p.add_argument("plotfile")
    p.add_argument("variable")
    p.add_argument("outfile")
    add_device_argument(p)
    args = p.parse_args(argv)
    makeplot(args.plotfile, args.variable, args.outfile,
             vmin=args.m, vmax=args.M, device=args.device)


if __name__ == "__main__":
    main()
