"""Viscous-incompressible extended BCs: "moving_lid" (unit tangential
velocity at the top wall) for the lid-driven cavity (the port of
pyro2_tpu/solvers/incompressible_viscous/BC.py).

Contract (see pyro2_tpu_torch.mesh.boundary.define_bc): the function fills
the ghosts of one variable of the full state stack in place and returns
the stack.  The multigrid calls it with a one-variable stack named "v"
(multigrid/MG.py `_fill_v`), which takes the y-velocity branch: at
multigrid level the lid's ghosts are 0.0 for the u solve as for the v
solve.  Only the state's own fill sets u = 1 on the lid.
"""

from pyro2_tpu_torch.util import msg


def user(bc_name, bc_edge, variable, ccdata, stack):
    """Fill the moving-lid ghost cells in place; returns the stack."""
    myg = ccdata.grid
    n = ccdata.names.index(variable)
    v = stack[n]

    if bc_name == "moving_lid":
        if bc_edge == "yrb":
            if variable in ("x-velocity", "u"):
                v[:, myg.jhi + 1:myg.jhi + myg.ng + 1] = 1.0
            elif variable in ("y-velocity", "v"):
                v[:, myg.jhi + 1:myg.jhi + myg.ng + 1] = 0.0
            else:
                raise NotImplementedError("variable not defined")
        else:
            msg.fail("error: moving_lid BC only implemented for 'yrb' "
                     "(top boundary)")
    else:
        msg.fail(f"error: bc type {bc_name} not supported")

    return stack
