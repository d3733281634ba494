"""Stencil views and ghost-cell filling on tensors.

The port of pyro2_tpu/mesh/indexer.py.  `ai` pairs a tensor with its grid
and returns shifted windows of the valid region as views (basic slicing, no
copy); `aic` is its constant stand-in for uniform Cartesian geometry;
`embed` places a windowed block into a zero-padded frame.  `fill_ghost`
fills the four ghost strips of a (..., qx, qy) tensor IN PLACE, in the
order x-lo, x-hi, y-lo, y-hi, so corner ghosts match the JAX package.
"""

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ai", "aic", "embed", "fill_ghost"]


class aic:
    """A constant-geometry stand-in for `ai`: every view is the same scalar.

    Cartesian grids have uniform Lx/Ly/Ax/Ay/V, so windowed reads of those
    arrays are one Python float."""

    __slots__ = ("c",)

    def __init__(self, c):
        self.c = float(c)

    def v(self, buf=0):
        return self.c

    def ip(self, shift, buf=0):
        return self.c

    def jp(self, shift, buf=0):
        return self.c

    def ip_jp(self, ishift, jshift, buf=0):
        return self.c


def _buf_split(b):
    """Expand an int / (lo,hi) / (xlo,xhi,ylo,yhi) ghost-buffer spec."""
    if isinstance(b, (tuple, list)):
        if len(b) == 2:
            return b[0], b[1], b[0], b[1]
        if len(b) == 4:
            return tuple(b)
        raise ValueError(f"bad buf spec: {b}")
    return b, b, b, b


def embed(vals, g, buf=0, ishift=0, jshift=0):
    """Place a buf-windowed block (shifted by ishift/jshift) into a
    zero-padded (..., qx, qy) frame: zeros outside the window."""
    bxlo, bxhi, bylo, byhi = _buf_split(buf)
    lo_x = g.ilo - bxlo + ishift
    lo_y = g.jlo - bylo + jshift
    hi_x_last = g.ihi + bxhi + ishift
    hi_y_last = g.jhi + byhi + jshift
    return F.pad(vals, (lo_y, g.qy - hi_y_last - 1,
                        lo_x, g.qx - hi_x_last - 1))


class ai:
    """A (tensor, grid) pair exposing the stencil-view algebra.

    The tensor has trailing dims (qx, qy); leading dims pass through.  Views
    are same-sized windows over the valid region, optionally shifted
    (ip/jp), buffered into the ghosts (buf) and strided (s)."""

    __slots__ = ("a", "g")

    def __init__(self, a, g):
        self.a = a
        self.g = g

    def _win(self, ishift, jshift, buf, s):
        g = self.g
        bxlo, bxhi, bylo, byhi = _buf_split(buf)
        isl = slice(g.ilo - bxlo + ishift, g.ihi + 1 + bxhi + ishift, s)
        jsl = slice(g.jlo - bylo + jshift, g.jhi + 1 + byhi + jshift, s)
        return self.a[..., isl, jsl]

    def v(self, buf=0, s=1):
        """The valid region (optionally including buf ghost cells)."""
        return self._win(0, 0, buf, s)

    def ip(self, shift, buf=0, s=1):
        """Valid-region-sized window shifted by `shift` zones in x."""
        return self._win(shift, 0, buf, s)

    def jp(self, shift, buf=0, s=1):
        """Valid-region-sized window shifted by `shift` zones in y."""
        return self._win(0, shift, buf, s)

    def ip_jp(self, ishift, jshift, buf=0, s=1):
        """Window shifted by ishift in x and jshift in y."""
        return self._win(ishift, jshift, buf, s)

    def lap(self, buf=0):
        """The 5-point Laplacian over the (buffered) valid region."""
        g = self.g
        return ((self.ip(-1, buf=buf) - 2.0 * self.v(buf=buf)
                 + self.ip(1, buf=buf)) / g.dx ** 2 +
                (self.jp(-1, buf=buf) - 2.0 * self.v(buf=buf)
                 + self.jp(1, buf=buf)) / g.dy ** 2)

    def norm(self):
        """Grid-weighted L2 norm over the valid region (a 0-d tensor)."""
        g = self.g
        return torch.sqrt(g.dx * g.dy * torch.sum(self.v() ** 2))

    def pretty_print(self, fmt=None):
        """Print the array with j increasing upward, ghost cells in red
        (the JAX package's ai.pretty_print)."""
        a = self.a.detach().cpu().numpy()
        if a.ndim != 2:
            raise ValueError("pretty_print expects a single 2-d component")
        if fmt is None:
            fmt = "%4d" if np.issubdtype(a.dtype, np.integer) else "%10.5g"
        g = self.g
        bold = "\033[31m"
        reset = "\033[0m"
        for j in reversed(range(g.qy)):
            row = []
            for i in range(g.qx):
                cell = fmt % a[i, j]
                interior = (g.ilo <= i <= g.ihi) and (g.jlo <= j <= g.jhi)
                row.append(cell if interior else bold + cell + reset)
            print(" ".join(row))
        print("\n         ^ y\n         |\n         +---> x\n")


# ---------------------------------------------------------------------------
# ghost-cell filling
# ---------------------------------------------------------------------------

def _edge_fill(a, g, axis, side, kind, value, dxy):
    """Fill one boundary's ghost strip of a (..., qx, qy) tensor in place.

    axis: -2 for x, -1 for y; side: 0 (low) / 1 (high).  Inhomogeneous
    Neumann/Dirichlet values constrain the first ghost zone only."""
    ng = g.ng
    n_tot = a.shape[axis]

    def take(idx_or_slice):
        idx = [slice(None)] * a.ndim
        idx[axis] = idx_or_slice
        return tuple(idx)

    if value is not None:
        value = torch.as_tensor(value, dtype=a.dtype, device=a.device)

    if side == 0:
        ghost = slice(0, ng)
        first_int = ng
        if kind in ("outflow", "neumann"):
            if value is None:
                a[take(ghost)] = a[take(slice(first_int, first_int + 1))]
            else:
                a[take(first_int - 1)] = a[take(first_int)] - dxy * value
        elif kind == "reflect-even":
            a[take(ghost)] = torch.flip(a[take(slice(ng, 2 * ng))], (axis,))
        elif kind in ("reflect-odd", "dirichlet"):
            if value is None:
                a[take(ghost)] = -torch.flip(a[take(slice(ng, 2 * ng))],
                                             (axis,))
            else:
                a[take(first_int - 1)] = 2.0 * value - a[take(first_int)]
        elif kind == "periodic":
            n_int = n_tot - 2 * ng
            a[take(ghost)] = a[take(slice(n_int, n_int + ng))].clone()
    else:
        hi = n_tot - ng - 1
        ghost = slice(hi + 1, n_tot)
        if kind in ("outflow", "neumann"):
            if value is None:
                a[take(ghost)] = a[take(slice(hi, hi + 1))]
            else:
                a[take(hi + 1)] = a[take(hi)] + dxy * value
        elif kind == "reflect-even":
            a[take(ghost)] = torch.flip(a[take(slice(hi - ng + 1, hi + 1))],
                                        (axis,))
        elif kind in ("reflect-odd", "dirichlet"):
            if value is None:
                a[take(ghost)] = -torch.flip(
                    a[take(slice(hi - ng + 1, hi + 1))], (axis,))
            else:
                a[take(hi + 1)] = 2.0 * value - a[take(hi)]
        elif kind == "periodic":
            a[take(ghost)] = a[take(slice(ng, 2 * ng))].clone()
    return a


def fill_ghost(a, g, bc):
    """Fill all four ghost strips of a (..., qx, qy) tensor per a BC spec,
    in place; returns `a`.  x boundaries are filled before y so the y fill
    sweeps full rows (ghost corners included)."""
    _edge_fill(a, g, -2, 0, bc.xlb, bc.xl_value, g.dx)
    _edge_fill(a, g, -2, 1, bc.xrb, bc.xr_value, g.dx)
    _edge_fill(a, g, -1, 0, bc.ylb, bc.yl_value, g.dy)
    _edge_fill(a, g, -1, 1, bc.yrb, bc.yr_value, g.dy)
    return a
