"""4th-order finite-volume data: cell-average <-> cell-center conversion.

The port of pyro2_tpu/mesh/fv.py: averages and centers differ by dx^2/24
times the Laplacian.  Assumes dx == dy.  The array functions return new
tensors and leave their input as it was.
"""

import torch

from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.mesh.patch import CellCenterData2d

__all__ = ["FV2d", "to_centers_array", "from_centers_array"]


def _window(g, buf):
    return (Ellipsis, slice(g.ilo - buf, g.ihi + 1 + buf),
            slice(g.jlo - buf, g.jhi + 1 + buf))


def to_centers_array(a, g, is_positive=False):
    """Convert a padded cell-average array to cell-center values.

    The buf=ng-1 window is converted; the outermost ghost ring is copied
    through unchanged (it has no Laplacian stencil).  With is_positive,
    cells whose converted value goes negative keep the average."""
    av = ai(a, g)
    b = g.ng - 1
    cv = av.v(buf=b) - g.dx ** 2 * av.lap(buf=b) / 24.0
    if is_positive:
        cv = torch.where(cv >= 0.0, cv, av.v(buf=b))
    out = a.clone()
    out[_window(g, b)] = cv
    return out


def from_centers_array(a, g):
    """Convert a padded cell-center array (ghosts filled) to averages.

    Only the valid region is converted; the ghosts are copied through."""
    av = ai(a, g)
    vv = av.v() + g.dx ** 2 * av.lap() / 24.0
    out = a.clone()
    out[_window(g, 0)] = vv
    return out


class FV2d(CellCenterData2d):
    """Finite-volume state: stored data are cell averages, ops 4th order."""

    def to_centers(self, name, is_positive=False):
        """The cell-center version of variable `name` (a full padded array)."""
        return to_centers_array(self.get_var(name), self.grid,
                                is_positive=is_positive)

    def from_centers(self, name):
        """Re-interpret the stored centers of `name` as averages: one ghost
        fill of the variable, then the valid-region conversion."""
        self.fill_BC(name)
        self.set_var(name, from_centers_array(self.get_var(name), self.grid))
