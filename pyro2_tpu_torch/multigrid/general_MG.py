r"""General-form multigrid: alpha phi + div(beta grad phi) + gamma.grad(phi) = f.

The port of pyro2_tpu/multigrid/general_MG.py: cell-centered alpha, beta,
gamma_x, gamma_y are restricted down the hierarchy once; beta is
edge-averaged (pre-scaled 1/dx^2).  Inhomogeneous solution BCs (the xl_BC
... functions) run on the plain path; the CUDA kernels take homogeneous BCs
only and raise for them (mg_kernel.check).

Each level's operator is one contiguous (5, q, q) stack, `planes[level]`:
alpha, beta_x, beta_y and the 0.5/dx- and 0.5/dy-prescaled gamma_x,
gamma_y.  The plain operator reads it, and the CUDA kernels
(multigrid/mg_kernel.py, the `general` entries) take it as it is.
"""

import torch

import pyro2_tpu_torch.multigrid.edge_coeffs as ec
from pyro2_tpu_torch.mesh.indexer import ai, embed, fill_ghost
from pyro2_tpu_torch.mesh.patch import restrict_array
from pyro2_tpu_torch.multigrid import MG

__all__ = ["GeneralMG2d"]

_COEFFS = ["alpha", "beta", "gamma_x", "gamma_y"]


class GeneralMG2d(MG.CellCenterMG2d):
    """Multigrid for the general linear elliptic operator."""

    def __init__(self, nx, ny, xmin=0.0, xmax=1.0, ymin=0.0, ymax=1.0,
                 xl_BC_type="dirichlet", xr_BC_type="dirichlet",
                 yl_BC_type="dirichlet", yr_BC_type="dirichlet",
                 xl_BC=None, xr_BC=None, yl_BC=None, yr_BC=None,
                 nsmooth=10, nsmooth_bottom=50,
                 verbose=0, coeffs=None,
                 true_function=None, *, device=None, dtype=None):
        """coeffs is a CellCenterData2d with alpha/beta/gamma_x/gamma_y."""
        super().__init__(nx, ny, ng=1,
                         xmin=xmin, xmax=xmax, ymin=ymin, ymax=ymax,
                         xl_BC_type=xl_BC_type, xr_BC_type=xr_BC_type,
                         yl_BC_type=yl_BC_type, yr_BC_type=yr_BC_type,
                         xl_BC=xl_BC, xr_BC=xr_BC,
                         yl_BC=yl_BC, yr_BC=yr_BC,
                         alpha=0.0, beta=0.0,
                         nsmooth=nsmooth, nsmooth_bottom=nsmooth_bottom,
                         verbose=verbose,
                         aux_field=_COEFFS,
                         aux_bc=[coeffs.BCs[c] for c in _COEFFS],
                         true_function=true_function, device=device,
                         dtype=dtype)

        fine = self.nlevels - 1
        g_f = self.grids[fine]
        for c in _COEFFS:
            bc_c = coeffs.BCs[c]
            c_in = torch.as_tensor(coeffs.get_var(c), dtype=self.dtype,
                                   device=self.device)
            if tuple(c_in.shape) == (g_f.qx, g_f.qy):
                arr = c_in.clone()
            else:
                # coefficients from a grid with a different ghost count:
                # only the valid region is used
                src_g = coeffs.grid
                arr = g_f.scratch_array(dtype=self.dtype, device=self.device)
                arr[g_f.ilo:g_f.ihi + 1, g_f.jlo:g_f.jhi + 1] = \
                    c_in[src_g.ilo:src_g.ihi + 1, src_g.jlo:src_g.jhi + 1]
            self.aux[c][fine] = fill_ghost(arr, g_f, bc_c)
            for n in range(self.nlevels - 2, -1, -1):
                cc = restrict_array(self.aux[c][n + 1], self.grids[n + 1],
                                    self.grids[n])
                self.aux[c][n] = fill_ghost(cc, self.grids[n], bc_c)

        beta_edge = [ec.EdgeCoeffs(g_f, self.aux["beta"][fine])]
        for n in range(self.nlevels - 2, -1, -1):
            beta_edge.insert(0, beta_edge[0].restrict())

        # one (alpha, beta_x, beta_y, gamma_x, gamma_y) stack per level,
        # the gammas pre-scaled as the smoother and residual use them
        self.planes = []
        for n, g in enumerate(self.grids):
            stack = torch.stack([self.aux["alpha"][n],
                                 beta_edge[n].x, beta_edge[n].y,
                                 0.5 * self.aux["gamma_x"][n] / g.dx,
                                 0.5 * self.aux["gamma_y"][n] / g.dy])
            beta_edge[n].x, beta_edge[n].y = stack[1], stack[2]
            self.planes.append(stack)
        self.beta_edge = beta_edge

    # -- operator overrides ------------------------------------------------
    def _coeff_views(self, level):
        g = self.grids[level]
        return tuple(ai(p, g) for p in self.planes[level])

    def _smooth_once(self, level, v, f):
        g = self.grids[level]
        alpha, beta_x, beta_y, gamma_x, gamma_y = self._coeff_views(level)
        red, black = MG._color_masks(g, v.device)

        def half_sweep(v, mask):
            vv = ai(v, g)
            denom = (alpha.v() -
                     beta_x.ip(1) - beta_x.v() -
                     beta_y.jp(1) - beta_y.v())
            upd = (ai(f, g).v() -
                   (beta_x.ip(1) + gamma_x.v()) * vv.ip(1) -
                   (beta_x.v() - gamma_x.v()) * vv.ip(-1) -
                   (beta_y.jp(1) + gamma_y.v()) * vv.jp(1) -
                   (beta_y.v() - gamma_y.v()) * vv.jp(-1)) / denom
            return torch.where(mask, embed(upd, g), v)

        v = self._fill_v(level, half_sweep(v, red))
        return self._fill_v(level, half_sweep(v, black))

    def _residual(self, level, v, f):
        g = self.grids[level]
        alpha, beta_x, beta_y, gamma_x, gamma_y = self._coeff_views(level)
        vv = ai(v, g)

        L_phi = (alpha.v() * vv.v() +
                 beta_x.ip(1) * (vv.ip(1) - vv.v()) -
                 beta_x.v() * (vv.v() - vv.ip(-1)) +
                 beta_y.jp(1) * (vv.jp(1) - vv.v()) -
                 beta_y.v() * (vv.v() - vv.jp(-1)) +
                 gamma_x.v() * (vv.ip(1) - vv.ip(-1)) +
                 gamma_y.v() * (vv.jp(1) - vv.jp(-1)))
        return embed(ai(f, g).v() - L_phi, g)
