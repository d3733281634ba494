"""A heated layer drives convection in an adiabatically stratified
atmosphere (uses the "ambient" BC at the top)."""

import numpy as np

from pyro2_tpu_torch.solvers.compressible.simulation import energy_source
from pyro2_tpu_torch.util import msg

DEFAULT_INPUTS = "inputs.convection"

PROBLEM_PARAMS = {"convection.dens_base": 10.0,
                  "convection.scale_height": 4.0,
                  "convection.y_height": 2.0,
                  "convection.thickness": 0.25,
                  "convection.e_rate": 0.1,
                  "convection.dens_cutoff": 0.01}


def init_data(my_data, rp):
    """Initialize the convection problem."""
    if rp.get_param("driver.verbose"):
        msg.bold("initializing the convection problem...")

    gamma = rp.get_param("eos.gamma")
    grav = rp.get_param("compressible.grav")
    scale_height = rp.get_param("convection.scale_height")
    dens_base = rp.get_param("convection.dens_base")
    dens_cutoff = rp.get_param("convection.dens_cutoff")

    # numpy's generator, seeded as the JAX package seeds it, so the
    # velocity noise is the same to the bit
    rng = np.random.default_rng(12345)
    g = my_data.grid
    dens = np.full((g.qx, g.qy), dens_cutoff)
    p = np.zeros((g.qx, g.qy))
    pres_base = scale_height * dens_base * abs(grav)

    for j in range(g.jlo, g.jhi + 1):
        profile = 1.0 - (gamma - 1.0) / gamma * g.y[j] / scale_height
        if profile > 0.0:
            dens[:, j] = max(dens_base * profile ** (1.0 / (gamma - 1.0)),
                             dens_cutoff)
        else:
            dens[:, j] = dens_cutoff
        if j == g.jlo:
            p[:, j] = pres_base
        elif dens[0, j] <= dens_cutoff + 1.e-30:
            p[:, j] = p[:, j - 1]
        else:
            p[:, j] = pres_base * (dens[:, j] / dens_base) ** gamma

    # the state the ambient BC at the top fills the ghosts with
    my_data.set_aux("ambient_rho", dens_cutoff)
    my_data.set_aux("ambient_u", 0.0)
    my_data.set_aux("ambient_v", 0.0)
    my_data.set_aux("ambient_p",
                    float(p[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1].min()))

    ener = p / (gamma - 1.0)

    # small random velocity perturbations where there is material
    vel_pert = 2.0 * rng.random(size=(g.qx, g.qy, 2)) - 1
    with np.errstate(divide="ignore", invalid="ignore"):
        cs = np.sqrt(gamma * p / dens)
    cs = np.nan_to_num(cs)
    idx = dens > 2 * dens_cutoff
    xmom = np.zeros_like(dens)
    ymom = np.zeros_like(dens)
    xmom[idx] = dens[idx] * 0.05 * cs[idx] * vel_pert[idx, 0]
    ymom[idx] = dens[idx] * 0.05 * cs[idx] * vel_pert[idx, 1]
    ener += 0.5 * (xmom ** 2 + ymom ** 2) / dens

    my_data.set_var("density", dens)
    my_data.set_var("x-momentum", xmom)
    my_data.set_var("y-momentum", ymom)
    my_data.set_var("energy", ener)


def source_weight(myg, rp):
    """(e_rate, w): the energy source is rho * e_rate * w, w a Gaussian of
    the height above y_height (float64, on the host)."""
    y_height = rp.get_param("convection.y_height")
    dist = np.abs(myg.y2d - y_height)
    thick = rp.get_param("convection.thickness")
    return rp.get_param("convection.e_rate"), np.exp(-(dist / thick) ** 2)


def source_terms(myg, U, ivars, rp):
    """Heating in a horizontal layer."""
    return energy_source(myg, U, ivars, rp, source_weight)


def finalize():
    """Print out any information to the user at the end of the run."""
