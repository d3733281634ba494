"""A multi-mode Rayleigh-Taylor instability (seeded with a fixed RNG)."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.rt_multimode"

PROBLEM_PARAMS = {"rt_multimode.dens1": 1.0,
                  "rt_multimode.dens2": 2.0,
                  "rt_multimode.amp": 1.0,
                  "rt_multimode.sigma": 0.1,
                  "rt_multimode.nmodes": 10,
                  "rt_multimode.p0": 10.0}


def init_data(my_data, rp):
    """Initialize the multimode rt problem."""
    rng = np.random.default_rng(12345)

    if rp.get_param("driver.verbose"):
        msg.bold("initializing the multimode rt problem...")

    gamma = rp.get_param("eos.gamma")
    grav = rp.get_param("compressible.grav")
    dens1 = rp.get_param("rt_multimode.dens1")
    dens2 = rp.get_param("rt_multimode.dens2")
    p0 = rp.get_param("rt_multimode.p0")
    amp = rp.get_param("rt_multimode.amp")
    sigma = rp.get_param("rt_multimode.sigma")
    nmodes = rp.get_param("rt_multimode.nmodes")

    g = my_data.grid
    ycenter = 0.5 * (g.ymin + g.ymax)

    dens = np.zeros((g.qx, g.qy))
    p = np.zeros((g.qx, g.qy))
    for j in range(g.jlo, g.jhi + 1):
        if g.y[j] < ycenter:
            dens[:, j] = dens1
            p[:, j] = p0 + dens1 * grav * g.y[j]
        else:
            dens[:, j] = dens2
            p[:, j] = (p0 + dens1 * grav * ycenter +
                       dens2 * grav * (g.y[j] - ycenter))

    L = g.xmax - g.xmin
    ymom = np.zeros_like(dens)
    for k in range(1, nmodes + 1):
        phase = rng.random() * 2 * np.pi
        mode_amp = amp * rng.random()
        ymom += (mode_amp * np.cos(2.0 * np.pi * k * g.x2d / L + phase) *
                 np.exp(-(g.y2d - ycenter) ** 2 / sigma ** 2))
    ymom = ymom / nmodes * dens
    xmom = np.zeros_like(dens)

    with np.errstate(divide="ignore", invalid="ignore"):
        ener = p / (gamma - 1.0) + \
            np.where(dens > 0.0, 0.5 * (xmom ** 2 + ymom ** 2) / dens, 0.0)

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", xmom)
    my_data.set_var("y-momentum", ymom)
    my_data.set_var("energy", ener)


def finalize():
    """Print out any information to the user at the end of the run."""
