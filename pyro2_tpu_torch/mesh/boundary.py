"""Boundary-condition metadata and the extensible BC registry.

A copy of pyro2_tpu/mesh/boundary.py (numpy only): a BC is a per-variable
container naming the condition on each of the 4 edges, with optional
inhomogeneous Dirichlet/Neumann edge-value functions (evaluated once at
construction) and an extension registry (`define_bc`) for solver-specific
conditions like "hse" / "ambient" / "ramp" / "moving_lid".

Custom BC functions take the full state tensor stack (nvar, qx, qy)
plus context, fill its ghosts in place and return it (see
`pyro2_tpu_torch.mesh.patch.CellCenterData2d.fill_BC`).  Signature::

    fn(bc_name, bc_edge, var_name, ccdata, stack) -> stack

where bc_edge is one of "xlb"/"xrb"/"ylb"/"yrb" and ccdata carries grid,
names, aux, ivars, and time.
"""

import numpy as np

__all__ = ["BC", "BCProp", "bc_is_solid", "define_bc", "bc_solid", "ext_bcs",
           "host_time_bcs"]

# is the boundary a solid wall (no flux) for Riemann-solver purposes?
bc_solid = {
    "outflow": False,
    "periodic": False,
    "reflect": True,
    "reflect-even": True,
    "reflect-odd": True,
    "dirichlet": True,
    "neumann": False,
}

# user-extended BC types: name -> pure fill function
ext_bcs = {}

# the user-extended BC types whose fill reads ccdata.t on the host
host_time_bcs = set()


def define_bc(bc_type, function, is_solid=False, reads_host_time=False):
    """Register a new named BC type with its (pure) fill function;
    reads_host_time marks a fill that reads the time on the host."""
    bc_solid[bc_type] = is_solid
    ext_bcs[bc_type] = function
    if reads_host_time:
        host_time_bcs.add(bc_type)
    else:
        host_time_bcs.discard(bc_type)


def _set_reflect(odd_reflect_dir, dir_string):
    if odd_reflect_dir == dir_string:
        return "reflect-odd"
    return "reflect-even"


class BCProp:
    """Per-edge property container (e.g. solid-wall flags)."""

    def __init__(self, xl_prop, xr_prop, yl_prop, yr_prop):
        self.xl = xl_prop
        self.xr = xr_prop
        self.yl = yl_prop
        self.yr = yr_prop


def bc_is_solid(bc):
    """BCProp of ints flagging which edges are solid walls."""
    return BCProp(int(bc_solid[bc.xlb]), int(bc_solid[bc.xrb]),
                  int(bc_solid[bc.ylb]), int(bc_solid[bc.yrb]))


class BC:
    """Boundary conditions for one variable on the 4 domain edges.

    "reflect" resolves to reflect-even unless odd_reflect_dir names this
    edge's direction.  Inhomogeneous Dirichlet/Neumann edge values come from
    the optional *_func callbacks, evaluated on the edge coordinate line at
    construction (host numpy) -- they only constrain the first ghost zone.
    """

    def __init__(self, *, xlb="outflow", xrb="outflow",
                 ylb="outflow", yrb="outflow",
                 xl_func=None, xr_func=None, yl_func=None, yr_func=None,
                 grid=None, odd_reflect_dir=""):
        valid = list(bc_solid.keys())

        for edge, val in (("xlb", xlb), ("xrb", xrb),
                          ("ylb", ylb), ("yrb", yrb)):
            if val not in valid:
                raise ValueError(f"ERROR: {edge} = {val} invalid BC")
            if val == "reflect":
                val = _set_reflect(odd_reflect_dir,
                                   "x" if edge[0] == "x" else "y")
            setattr(self, edge, val)

        if (xlb == "periodic") != (xrb == "periodic"):
            raise ValueError("ERROR: both xlb and xrb must be periodic")
        if (ylb == "periodic") != (yrb == "periodic"):
            raise ValueError("ERROR: both ylb and yrb must be periodic")

        self.xl_value = self.xr_value = self.yl_value = self.yr_value = None
        if xl_func is not None:
            self.xl_value = np.asarray(xl_func(grid.y))
        if xr_func is not None:
            self.xr_value = np.asarray(xr_func(grid.y))
        if yl_func is not None:
            self.yl_value = np.asarray(yl_func(grid.x))
        if yr_func is not None:
            self.yr_value = np.asarray(yr_func(grid.x))

    def _key(self):
        def v(x):
            return None if x is None else x.tobytes()
        return (self.xlb, self.xrb, self.ylb, self.yrb,
                v(self.xl_value), v(self.xr_value),
                v(self.yl_value), v(self.yr_value))

    def __eq__(self, other):
        return isinstance(other, BC) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __str__(self):
        return (f"BCs: -x: {self.xlb}  +x: {self.xrb}  "
                f"-y: {self.ylb}  +y: {self.yrb}")
