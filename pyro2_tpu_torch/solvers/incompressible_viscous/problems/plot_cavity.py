#!/usr/bin/env python3
"""Plot velocity magnitude + streamlines for a lid-driven cavity output (the
port of pyro2_tpu/solvers/incompressible_viscous/problems/plot_cavity.py).

usage: python -m pyro2_tpu_torch.solvers.incompressible_viscous.problems.\\
plot_cavity [--device cpu] plotfile [-o out.png] [-R reynolds] \\
           [-d streamline_density]

matplotlib is imported inside `makeplot`: plot on a machine that has it.
"""

import argparse

import numpy as np

import pyro2_tpu_torch.util.io_pyro as io


def makeplot(plotfile_name, outfile, reynolds=None, streamline_density=2.0,
             *, device=None):
    """Plot the velocity magnitude and streamlines of a cavity run."""
    import matplotlib.pyplot as plt

    sim = io.read(plotfile_name, device=device)
    myg = sim.cc_data.grid
    x = np.asarray(myg.x[myg.ilo:myg.ihi + 1])
    y = np.asarray(myg.y[myg.jlo:myg.jhi + 1])
    sl = (slice(myg.ilo, myg.ihi + 1), slice(myg.jlo, myg.jhi + 1))
    u = sim.cc_data.get_var("x-velocity")[sl].detach().cpu().numpy()
    v = sim.cc_data.get_var("y-velocity")[sl].detach().cpu().numpy()
    magvel = np.sqrt(u ** 2 + v ** 2)

    fig, ax = plt.subplots(figsize=(6, 5.5))
    img = ax.imshow(magvel.T, origin="lower", cmap="viridis",
                    extent=[myg.xmin, myg.xmax, myg.ymin, myg.ymax])
    # streamplot wants (ny, nx) arrays indexed [y, x]
    ax.streamplot(x, y, u.T, v.T, color="white", linewidth=0.7,
                  density=streamline_density)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    title = "Lid-driven cavity"
    if reynolds is not None:
        title += f", Re = {reynolds:g}"
    title += f", t = {sim.cc_data.t:.3g}"
    ax.set_title(title)
    fig.colorbar(img, ax=ax, label="|U|")
    fig.tight_layout()
    fig.savefig(outfile, dpi=150)
    print(f"wrote {outfile}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("plotfile", help="cavity output file (.h5)")
    p.add_argument("-o", dest="outfile", default="cavity.png",
                   help="output image name")
    p.add_argument("-R", dest="reynolds", type=float, default=None,
                   help="Reynolds number (title annotation only)")
    p.add_argument("-d", dest="density", type=float, default=2.0,
                   help="streamline density")
    p.add_argument("--device", default=None,
                   help="device to read the output onto (default: the card)")
    args = p.parse_args(argv)
    makeplot(args.plotfile, args.outfile, args.reynolds, args.density,
             device=args.device)


if __name__ == "__main__":
    main()
