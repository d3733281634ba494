"""The logo problem: the word "pyro" rendered as a density field in the
domain center, scrambled by converging corner blasts."""

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

    # render the word into a small figure and sample the green channel
    fig = plt.figure(2, (0.64, 0.64), dpi=100 * g.nx / 64)
    fig.add_subplot(111)
    fig.text(0.5, 0.5, "pyro", transform=fig.transFigure, fontsize="16",
             horizontalalignment="center", verticalalignment="center")
    plt.axis("off")
    fig.canvas.draw()
    data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    w, h = fig.canvas.get_width_height()
    data = data.reshape((h, w, 4))[:, :, :3]
    plt.close(fig)

    # widen the uint8 channel first: under numpy >= 2, 256 - uint8 raises
    # OverflowError (the JAX package's copy does); numpy 1 widened it
    green = data[:, :, 1].astype(np.int64)
    logo = np.rot90(np.rot90(np.rot90((256 - green) / 255.0)))

    dens = np.ones((g.qx, g.qy))
    # sample/crop onto the interior (pad or trim as needed)
    li = min(logo.shape[0], g.nx)
    lj = min(logo.shape[1], g.ny)
    interior = np.zeros((g.nx, g.ny))
    interior[:li, :lj] = logo[:li, :lj] * 50.0
    dens[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = interior

    gamma = rp.get_param("eos.gamma")
    p_ambient = 1.e-5
    ener = np.full((g.qx, g.qy), p_ambient / (gamma - 1.0))
    for i, j in [(g.ilo, g.jlo), (g.ilo, g.jhi),
                 (g.ihi, g.jlo), (g.ihi, g.jhi)]:
        ener[i, j] = 1.0

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", np.zeros_like(dens))
    my_data.set_var("y-momentum", np.zeros_like(dens))
    my_data.set_var("energy", ener)


def finalize():
    """Print out any information to the user at the end of the run."""
