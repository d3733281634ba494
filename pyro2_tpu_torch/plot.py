#!/usr/bin/env python3
"""Re-plot any output file through its solver's dovis (the port of
pyro2_tpu/plot.py).

    python -m pyro2_tpu_torch.plot [--device cpu] [-o out.png] [-W 8 -H 6] \\
        [--dpi 100] file.h5

matplotlib is imported inside `makeplot`, so plot on a machine that has
it; the state is read onto `--device` (the card by default) and comes
back to the host once, in dovis.
"""

import argparse
import os

import pyro2_tpu_torch.util.io_pyro as io


def makeplot(plotfile_name, outfile, *, width=None, height=None, dpi=100,
             device=None):
    """Plot the data in a plotfile using the solver's dovis."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    sim = io.read(plotfile_name, device=device)

    # reuse-or-reset figure 1, setting size/dpi explicitly (figure()
    # kwargs are silently ignored -- with a warning -- when the figure
    # already exists in this process)
    fig = plt.figure(num=1, clear=True)
    fig.set_dpi(dpi)
    if width is not None and height is not None:
        fig.set_size_inches(width, height)

    sim.dovis()
    plt.savefig(outfile, bbox_inches="tight", dpi=dpi)
    print(f"saved {outfile}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-o", type=str, default=None, help="output file name")
    p.add_argument("-W", type=float, default=None, help="width (inches)")
    p.add_argument("-H", type=float, default=None, help="height (inches)")
    p.add_argument("--dpi", type=int, default=100)
    p.add_argument("--device", default=None,
                   help="device to read the output onto (default: the card)")
    p.add_argument("plotfile", type=str)
    args = p.parse_args(argv)

    out = args.o
    if out is None:
        out = os.path.basename(args.plotfile).replace(".h5", "") + ".png"
    makeplot(args.plotfile, out, width=args.W, height=args.H, dpi=args.dpi,
             device=args.device)


if __name__ == "__main__":
    main()
