"""Derived variables for the compressible solver
(the port of pyro2_tpu/solvers/compressible/derives.py)."""

import torch

from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.solvers.compressible import eos


def derive_primitives(myd, varnames):
    """Derive primitive/diagnostic fields from the conserved state."""
    dens = myd.get_var("density")
    xmom = myd.get_var("x-momentum")
    ymom = myd.get_var("y-momentum")
    ener = myd.get_var("energy")

    derived_vars = []

    u = xmom / dens
    v = ymom / dens
    e = (ener - 0.5 * dens * (u * u + v * v)) / dens

    gamma = myd.get_aux("gamma")
    p = eos.pres(gamma, dens, e)

    myg = myd.grid
    uv = ai(u, myg)
    vv = ai(v, myg)
    vort = torch.zeros_like(u)
    vort[myg.ilo:myg.ihi + 1, myg.jlo:myg.jhi + 1] = (
        0.5 * (vv.ip(1) - vv.ip(-1)) / myg.dx -
        0.5 * (uv.jp(1) - uv.jp(-1)) / myg.dy)

    wanted = [varnames] if isinstance(varnames, str) else list(varnames)

    for var in wanted:
        if var == "velocity":
            derived_vars.append(u)
            derived_vars.append(v)
        elif var in ["e", "eint"]:
            derived_vars.append(e)
        elif var in ["p", "pressure"]:
            derived_vars.append(p)
        elif var == "primitive":
            derived_vars.extend([dens, u, v, p])
        elif var == "soundspeed":
            derived_vars.append(torch.sqrt(gamma * p / dens))
        elif var == "machnumber":
            derived_vars.append(torch.sqrt(u ** 2 + v ** 2) /
                                torch.sqrt(gamma * p / dens))
        elif var == "vorticity":
            derived_vars.append(vort)

    if len(derived_vars) > 1:
        return derived_vars
    if not derived_vars:
        return None
    return derived_vars[0]
