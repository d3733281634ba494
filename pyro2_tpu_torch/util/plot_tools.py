"""Plot-layout helpers for runtime visualization.

The port of pyro2_tpu/util/plot_tools.py: an aspect-ratio-aware ImageGrid
layout and the field plotter the solvers' `dovis` methods share.  The
fields reach the host in one copy (`host_interiors`); matplotlib is
imported inside each function, so the port imports without it (the GPU
machine has none: plot on the CPU).
"""

import math

import torch

from pyro2_tpu_torch.mesh.indexer import ai, embed

__all__ = ["host_interiors", "plot_fields", "setup_axes", "vorticity"]


def _key_handler(event):
    if event.key == "ctrl+c":
        from pyro2_tpu_torch.util import msg
        msg.fail("ABORT: KeyboardInterrupt")


def setup_axes(myg, num):
    """Create a grid of axes laid out to suit the domain aspect ratio."""
    import matplotlib.pyplot as plt
    from mpl_toolkits.axes_grid1 import ImageGrid

    L_x = myg.xmax - myg.xmin
    L_y = myg.ymax - myg.ymin

    f = plt.figure(1)
    f.canvas.mpl_connect("key_press_event", _key_handler)

    cbar_title = False

    if L_x > 2 * L_y:
        axes = ImageGrid(f, 111, nrows_ncols=(num, 1), share_all=True,
                         cbar_mode="each", cbar_location="top",
                         cbar_pad="10%", cbar_size="25%",
                         axes_pad=(0.25, 0.65), label_mode="L")
        cbar_title = True
    elif L_y > 2 * L_x:
        axes = ImageGrid(f, 111, nrows_ncols=(1, num), share_all=True,
                         cbar_mode="each", cbar_location="right",
                         cbar_pad="10%", cbar_size="25%",
                         axes_pad=(0.65, 0.25), label_mode="L")
    else:
        ny = math.ceil(math.sqrt(num))
        nx = math.ceil(num / ny)
        axes = ImageGrid(f, 111, nrows_ncols=(nx, ny), share_all=True,
                         cbar_mode="each", cbar_location="right",
                         cbar_pad="2%", axes_pad=(0.65, 0.25), label_mode="L")

    return f, axes, cbar_title


def vorticity(u, v, myg):
    """The centred-difference vorticity dv/dx - du/dy of two (qx, qy)
    velocity tensors on the valid region, zero in the ghosts."""
    uv, vv = ai(u, myg), ai(v, myg)
    return embed(0.5 * (vv.ip(1) - vv.ip(-1)) / myg.dx -
                 0.5 * (uv.jp(1) - uv.jp(-1)) / myg.dy, myg)


def host_interiors(myg, arrays):
    """The valid regions of (qx, qy) tensors as one numpy (n, nx, ny)
    array, in one device-to-host copy."""
    stack = torch.stack([a[myg.ilo:myg.ihi + 1, myg.jlo:myg.jhi + 1]
                         for a in arrays])
    return stack.detach().cpu().numpy()


def plot_fields(sim, fields, title=None):
    """Generic dovis body: imshow each (name, padded tensor) pair."""
    import matplotlib.pyplot as plt
    import numpy as np

    plt.clf()
    myg = sim.cc_data.grid
    _, axes, cbar_title = setup_axes(myg, len(fields))
    values = host_interiors(myg, [arr for _, arr in fields])

    for n, (name, _) in enumerate(fields):
        ax = axes[n]
        img = ax.imshow(np.transpose(values[n]), interpolation="nearest",
                        origin="lower",
                        extent=[myg.xmin, myg.xmax, myg.ymin, myg.ymax],
                        cmap=sim.cm)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        if cbar_title:
            cb = axes.cbar_axes[n].colorbar(img)
            cb.ax.set_title(name)
        else:
            axes.cbar_axes[n].colorbar(img)
            ax.set_title(name)

    if title is not None:
        plt.suptitle(title)
    plt.figtext(0.05, 0.0125, f"t = {sim.cc_data.t:10.5f}")
    plt.pause(0.001)
    plt.draw()
