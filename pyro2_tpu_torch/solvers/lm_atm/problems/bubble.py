"""A buoyant bubble in an isothermal hydrostatic atmosphere (low-Mach
version; comparable with the compressible bubble problem).

The port of pyro2_tpu/solvers/lm_atm/problems/bubble.py: the fields are
built in host numpy float64, as there, and handed to the state container
(which converts them to its device and dtype); the base-state profiles stay
host numpy float64."""

import numpy as np

from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.bubble"

PROBLEM_PARAMS = {"bubble.dens_base": 10.0,
                  "bubble.scale_height": 2.0,
                  "bubble.x_pert": 2.0,
                  "bubble.y_pert": 2.0,
                  "bubble.r_pert": 0.25,
                  "bubble.pert_amplitude_factor": 5.0,
                  "bubble.dens_cutoff": 0.01}


def init_data(my_data, base, rp):
    """Initialize the low-Mach bubble problem (state + base profiles)."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the bubble problem...")

    grav = rp.get_param("lm-atmosphere.grav")
    gamma = rp.get_param("eos.gamma")
    scale_height = rp.get_param("bubble.scale_height")
    dens_base = rp.get_param("bubble.dens_base")
    dens_cutoff = rp.get_param("bubble.dens_cutoff")
    x_pert = rp.get_param("bubble.x_pert")
    y_pert = rp.get_param("bubble.y_pert")
    r_pert = rp.get_param("bubble.r_pert")
    pert_amplitude_factor = rp.get_param("bubble.pert_amplitude_factor")

    g = my_data.grid
    dens = np.full((g.qx, g.qy), dens_cutoff)
    for j in range(g.jlo, g.jhi + 1):
        dens[:, j] = max(dens_base * np.exp(-g.y[j] / scale_height),
                         dens_cutoff)

    cs2 = scale_height * abs(grav)
    pres = cs2 * dens
    eint = pres / (gamma - 1.0) / dens

    # boost eint inside the bubble at constant pressure
    r = np.sqrt((g.x2d - x_pert) ** 2 + (g.y2d - y_pert) ** 2)
    idx = r <= r_pert
    eint[idx] = eint[idx] * pert_amplitude_factor
    dens[idx] = pres[idx] / (eint[idx] * (gamma - 1.0))

    my_data.set_var("density", dens)
    my_data.set_var("x-velocity", np.zeros_like(dens))
    my_data.set_var("y-velocity", np.zeros_like(dens))
    my_data.set_var("eint", eint)

    # base state: lateral means, pressure re-done via discrete HSE
    base["rho0"].d[:] = np.mean(dens, axis=0)
    base["p0"].d[:] = np.mean(pres, axis=0)
    for j in range(g.jlo + 1, g.jhi):
        base["p0"].d[j] = base["p0"].d[j - 1] + 0.5 * g.dy * (
            base["rho0"].d[j] + base["rho0"].d[j - 1]) * grav


def finalize():
    """Print out any information to the user at the end of the run."""
