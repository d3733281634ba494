"""The logo problem on shallow water: the rendered word as a height
perturbation."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.logo"

PROBLEM_PARAMS = {}


def init_data(my_data, rp):
    """Initialize the logo problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the logo problem...")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    g = my_data.grid
    fig = plt.figure(2, (0.64, 0.64), dpi=100 * g.nx / 64)
    fig.add_subplot(111)
    fig.text(0.5, 0.5, "pyro", transform=fig.transFigure, fontsize="16",
             horizontalalignment="center", verticalalignment="center")
    plt.axis("off")
    fig.canvas.draw()
    data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, hgt = fig.canvas.get_width_height()
    data = data.reshape((hgt, w, 4))[:, :, :3]
    plt.close(fig)
    # widen the uint8 channel first: under numpy >= 2, 256 - uint8 raises
    # OverflowError (the JAX package's copy does); numpy 1 widened it
    green = data[:, :, 1].astype(np.int64)
    logo = np.rot90(np.rot90(np.rot90((256 - green) / 255.0)))

    h = np.ones((g.qx, g.qy))
    li = min(logo.shape[0], g.nx)
    lj = min(logo.shape[1], g.ny)
    interior = np.ones((g.nx, g.ny))
    interior[:li, :lj] += logo[:li, :lj]
    h[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = interior

    my_data.set_var("height", h)
    my_data.set_var("x-momentum", np.zeros_like(h))
    my_data.set_var("y-momentum", np.zeros_like(h))
    my_data.set_var("fuel", h ** 2 / np.max(h))


def finalize():
    """Print out any information to the user at the end of the run."""
