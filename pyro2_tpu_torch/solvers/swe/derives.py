"""Derived variables for the shallow water solver
(the port of pyro2_tpu/solvers/swe/derives.py)."""

import torch


def derive_primitives(myd, varnames):
    """Derive primitive/diagnostic fields from the conserved state."""
    h = myd.get_var("height")
    xmom = myd.get_var("x-momentum")
    ymom = myd.get_var("y-momentum")

    u = xmom / h
    v = ymom / h
    g = myd.get_aux("g")

    derived_vars = []
    wanted = [varnames] if isinstance(varnames, str) else list(varnames)
    for var in wanted:
        if var == "velocity":
            derived_vars.append(u)
            derived_vars.append(v)
        elif var == "primitive":
            derived_vars.extend([h, u, v])
        elif var == "soundspeed":
            derived_vars.append(torch.sqrt(g * h))

    if len(derived_vars) > 1:
        return derived_vars
    if not derived_vars:
        return None
    return derived_vars[0]
