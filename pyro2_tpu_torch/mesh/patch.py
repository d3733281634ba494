"""Cell-centered state container and the grid transfer operators.

The port of pyro2_tpu/mesh/patch.py's CellCenterData2d: registration and
metadata live on the Python object, the state is one (nvar, qx, qy) tensor
with y the fastest-varying dim, on an explicit device and dtype.  Ghost
fills update that tensor in place.  `restrict_array` / `prolong_array` are
the factor-2 (and 4) transfers multigrid uses; `cell_center_data_clone`
copies the state, because the port writes state tensors in place.
"""

import torch

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.defaults import dtype as working_dtype
from pyro2_tpu_torch.defaults import resolve_device
from pyro2_tpu_torch.mesh.indexer import ai, fill_ghost
from pyro2_tpu_torch.util import hdf5

__all__ = ["CellCenterData2d", "cell_center_data_clone", "restrict_array",
           "prolong_array"]


# ---------------------------------------------------------------------------
# transfer operators (shared with multigrid)
# ---------------------------------------------------------------------------

def restrict_array(fdata, fgrid, cgrid, N=2):
    """Average a fine (..., qx, qy) tensor onto the factor-N coarser grid.

    Conservative box average; ghost zones of the result are zero."""
    f = ai(fdata, fgrid)
    if N == 2:
        avg = 0.25 * (f.v(s=2) + f.ip(1, s=2) + f.jp(1, s=2)
                      + f.ip_jp(1, 1, s=2))
    elif N == 4:
        avg = sum(f.ip_jp(i, j, s=4) for i in range(4)
                  for j in range(4)) / 16.0
    else:
        raise ValueError("restriction is only allowed by 2 or 4")
    cdata = fdata.new_zeros(fdata.shape[:-2] + (cgrid.qx, cgrid.qy))
    cdata[..., cgrid.ilo:cgrid.ihi + 1, cgrid.jlo:cgrid.jhi + 1] = avg
    return cdata


def prolong_array(cdata, cgrid, fgrid):
    """Bilinear-with-centered-slopes prolongation to the 2x finer grid.

    Each coarse zone's reconstruction f(x,y) = <f> + m_x x/dx + m_y y/dy is
    averaged over its 4 children.  Ghosts zero."""
    c = ai(cdata, cgrid)
    m_x = 0.5 * (c.ip(1) - c.ip(-1))
    m_y = 0.5 * (c.jp(1) - c.jp(-1))

    fdata = cdata.new_zeros(cdata.shape[:-2] + (fgrid.qx, fgrid.qy))
    ilo, ihi = fgrid.ilo, fgrid.ihi
    jlo, jhi = fgrid.jlo, fgrid.jhi
    cv = c.v()
    for di, dj, sx, sy in ((0, 0, -1, -1), (1, 0, 1, -1),
                           (0, 1, -1, 1), (1, 1, 1, 1)):
        fdata[..., ilo + di:ihi + 1:2, jlo + dj:jhi + 1:2] = \
            cv + 0.25 * sx * m_x + 0.25 * sy * m_y
    return fdata


class CellCenterData2d:
    """Multi-variable cell-centered state on a ghost-cell grid.

    Register variables (each with its BC), set aux scalars, then `create()`
    to allocate the (nvar, qx, qy) tensor.  `device` defaults to CUDA and
    raises when there is none; `dtype` defaults to the device's working
    dtype (see pyro2_tpu_torch.defaults)."""

    def __init__(self, grid, *, dtype=None, device=None):
        self.grid = grid
        self.device = resolve_device(device)
        self.dtype = working_dtype(self.device, dtype)
        self.data = None

        self.names = []
        self.vars = self.names  # backwards-compatible alias
        self.nvar = 0
        self.ivars = []

        self.aux = {}
        self.derives = []
        self.BCs = {}

        self.t = -1.0
        self.initialized = 0

    # -- setup --------------------------------------------------------------
    def register_var(self, name, bc):
        if self.initialized == 1:
            raise RuntimeError("ERROR: grid already initialized")
        self.names.append(name)
        self.nvar += 1
        self.BCs[name] = bc

    def set_aux(self, keyword, value):
        self.aux[keyword] = value

    def get_aux(self, keyword):
        return self.aux.get(keyword, None)

    def add_derived(self, func):
        """Register a derived-variable callback f(ccdata, name) -> tensor."""
        self.derives.append(func)

    def add_ivars(self, ivars):
        self.ivars = ivars

    def create(self):
        if self.initialized == 1:
            raise RuntimeError("ERROR: grid already initialized")
        self.data = torch.zeros((self.nvar, self.grid.qx, self.grid.qy),
                                dtype=self.dtype, device=self.device)
        self.initialized = 1

    # -- access -------------------------------------------------------------
    def get_var(self, name):
        """The (qx, qy) tensor for a stored or derived variable.

        A list of names queries the derived-variable callbacks directly
        (e.g. ["velocity", "soundspeed"] -> [u, v, cs])."""
        if not isinstance(name, str):
            for f in self.derives:
                var = f(self, name)
                if var is not None and len(var) > 0:
                    return var
            raise KeyError(f"names {name} are not valid")
        try:
            n = self.names.index(name)
        except ValueError:
            for f in self.derives:
                var = f(self, name)
                if var is not None and len(var) > 0:
                    return var
            raise KeyError(f"name {name} is not valid") from None
        return self.data[n]

    def get_var_by_index(self, n):
        return self.data[n]

    def get_vars(self):
        """The full (nvar, qx, qy) stack."""
        return self.data

    def set_var(self, name, arr):
        """Replace a variable's full (qx, qy) array (numpy or tensor)."""
        n = self.names.index(name)
        self.data[n] = torch.as_tensor(arr, dtype=self.dtype,
                                       device=self.device)

    def set_vars(self, stack):
        """Replace the full (nvar, qx, qy) stack."""
        self.data = torch.as_tensor(stack, dtype=self.dtype,
                                    device=self.device).contiguous()

    def zero(self, name):
        self.data[self.names.index(name)] = 0.0

    def min(self, name, *, ng=0):
        n = self.names.index(name)
        return float(ai(self.data[n], self.grid).v(buf=ng).min())

    def max(self, name, *, ng=0):
        n = self.names.index(name)
        return float(ai(self.data[n], self.grid).v(buf=ng).max())

    # -- ghost filling ------------------------------------------------------
    def _fill_var(self, stack, n, name):
        bc = self.BCs[name]
        fill_ghost(stack[n], self.grid, bc)
        for edge in ("xlb", "xrb", "ylb", "yrb"):
            btype = getattr(bc, edge)
            if btype in bnd.ext_bcs:
                stack = bnd.ext_bcs[btype](btype, edge, name, self, stack)
        return stack

    def fill_BC(self, name):
        """Fill one variable's ghosts (standard + any extended BC types)."""
        self.data = self._fill_var(self.data, self.names.index(name), name)

    def fill_BC_all(self):
        for name in self.names:
            self.fill_BC(name)

    def fill_bc_stack(self, stack, t=None):
        """Ghost fill of an externally-held stack, in place; returns it.

        Applies each variable's standard BC, then any extended BCs, without
        touching self.data.  `t` overrides the container time for
        time-dependent custom BCs (e.g. "ramp")."""
        old_t = self.t
        if t is not None:
            self.t = t
        try:
            for n, name in enumerate(self.names):
                stack = self._fill_var(stack, n, name)
        finally:
            self.t = old_t
        return stack

    # -- coarsen / refine ---------------------------------------------------
    def restrict(self, varname, N=2):
        """Conservatively restrict one variable to a factor-N coarser grid."""
        cgrid = self.grid.coarse_like(N)
        return restrict_array(self.get_var(varname), self.grid, cgrid, N)

    def prolong(self, varname):
        """Prolong one variable to a 2x finer grid."""
        fgrid = self.grid.fine_like(2)
        return prolong_array(self.get_var(varname), self.grid, fgrid)

    def pretty_print(self, varname, fmt=None):
        """Print one variable with ghost cells marked."""
        ai(self.get_var(varname), self.grid).pretty_print(fmt=fmt)

    # -- I/O ----------------------------------------------------------------
    def write(self, filename):
        """Write grid + state to an HDF5 file (the JAX package's layout,
        through util/hdf5.py)."""
        if not filename.endswith(".h5"):
            filename += ".h5"
        with hdf5.File(filename, "w") as f:
            self.write_data(f)

    def write_data(self, f):
        gaux = f.create_group("aux")
        for k, v in self.aux.items():
            gaux.attrs[k] = v

        ggrid = f.create_group("grid")
        for att in ("nx", "ny", "ng", "xmin", "xmax", "ymin", "ymax"):
            ggrid.attrs[att] = getattr(self.grid, att)
        if hasattr(self.grid, "coord_type"):
            ggrid.attrs["coord_type"] = self.grid.coord_type

        gstate = f.create_group("state")
        for n, name in enumerate(self.names):
            gvar = gstate.create_group(name)
            gvar.create_dataset(
                "data",
                data=ai(self.data[n], self.grid).v().cpu().numpy())
            for edge in ("xlb", "xrb", "ylb", "yrb"):
                gvar.attrs[edge[:2] + "b"] = getattr(self.BCs[name], edge)

    def __str__(self):
        if self.initialized == 0:
            return "CellCenterData2d object not yet initialized"
        g = self.grid
        s = (f"cc data: nx = {g.nx}, ny = {g.ny}, ng = {g.ng}\n"
             f"         nvars = {self.nvar}\n         variables:\n")
        for name in self.names:
            b = self.BCs[name]
            s += (f"{name:>16s}: min: {self.min(name):15.10f}    "
                  f"max: {self.max(name):15.10f}\n")
            s += (f"{' ':>16s}  BCs: -x: {b.xlb:12s} +x: {b.xrb:12s}"
                  f" -y: {b.ylb:12s} +y: {b.yrb:12s}\n")
        return s


def cell_center_data_clone(old):
    """Deep-copy a CellCenterData2d (BCs, aux, derives, data, time).

    The state tensor is copied: the port writes state in place, so a clone
    that shared it would change with the original."""
    if not isinstance(old, CellCenterData2d):
        raise TypeError("Can't clone object")
    new = type(old)(old.grid, dtype=old.dtype, device=old.device)
    for name in old.names:
        new.register_var(name, old.BCs[name])
    new.create()
    new.aux = old.aux.copy()
    new.data = old.data.clone()
    new.derives = old.derives.copy()
    new.ivars = old.ivars
    new.t = old.t
    return new
