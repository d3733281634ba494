"""Edge-centered coefficients for variable-coefficient multigrid.

The port of pyro2_tpu/multigrid/edge_coeffs.py: cell-centered eta averaged
to x/y faces, pre-scaled by 1/dx^2 (1/dy^2), with a factor-2 coarsening
that averages the two fine faces making up each coarse face.  Tensors are
on eta's device and dtype; nothing here writes its input.
"""

import torch

from pyro2_tpu_torch.mesh.indexer import ai

__all__ = ["EdgeCoeffs"]


class EdgeCoeffs:
    """Holds x[i,j] = eta_{i-1/2,j}/dx^2 and y[i,j] = eta_{i,j-1/2}/dy^2."""

    def __init__(self, g, eta, empty=False):
        self.grid = g

        if not empty:
            ev = ai(eta, g)
            b = (0, 1)                      # lo..hi+1 on both axes
            x_w = 0.5 * (ev.ip(-1, buf=b) + ev.v(buf=b)) / g.dx ** 2
            y_w = 0.5 * (ev.jp(-1, buf=b) + ev.v(buf=b)) / g.dy ** 2

            sl = (slice(g.ilo, g.ihi + 2), slice(g.jlo, g.jhi + 2))
            self.x = torch.zeros_like(eta)
            self.y = torch.zeros_like(eta)
            self.x[sl] = x_w
            self.y[sl] = y_w

    def restrict(self):
        """Edge coefficients on the factor-2 coarser grid (new EdgeCoeffs)."""
        fg = self.grid
        cg = fg.coarse_like(2)

        xv = ai(self.x, fg)
        yv = ai(self.y, fg)

        # coarse x-face value = average of the two stacked fine x-faces
        bx = (0, 1, 0, 0)
        cx_w = 0.5 * (xv.v(buf=bx, s=2) + xv.jp(1, buf=bx, s=2))
        # coarse y-face value = average of the two side-by-side fine y-faces
        by = (0, 0, 0, 1)
        cy_w = 0.5 * (yv.v(buf=by, s=2) + yv.ip(1, buf=by, s=2))

        c = EdgeCoeffs(cg, None, empty=True)
        scale_x = fg.dx ** 2 / cg.dx ** 2
        scale_y = fg.dy ** 2 / cg.dy ** 2

        c.x = self.x.new_zeros((cg.qx, cg.qy))
        c.y = self.y.new_zeros((cg.qx, cg.qy))
        c.x[cg.ilo:cg.ihi + 2, cg.jlo:cg.jhi + 1] = cx_w * scale_x
        c.y[cg.ilo:cg.ihi + 1, cg.jlo:cg.jhi + 2] = cy_w * scale_y
        return c
