r"""Variable-coefficient multigrid: div( eta grad(phi) ) = f.

The port of pyro2_tpu/multigrid/variable_coeff_MG.py: eta lives
cell-centered on the finest level, is conservatively restricted down the
hierarchy once at construction, and is averaged onto edges (pre-scaled by
1/dx^2) per level, each coarse level's edges restricted from the finer
level's.  The smoother and residual are the masked red-black forms of the
edge-coefficient 5-point operator.

Each level's two edge planes are kept as one contiguous (2, q, q) stack,
`planes[level]` (eta_x, eta_y): the plain operator reads them, and the CUDA
kernels (multigrid/mg_kernel.py, the `vc` entries) take them as they are.
"""

import torch

import pyro2_tpu_torch.multigrid.edge_coeffs as ec
from pyro2_tpu_torch.mesh.indexer import ai, embed, fill_ghost
from pyro2_tpu_torch.mesh.patch import restrict_array
from pyro2_tpu_torch.multigrid import MG

__all__ = ["VarCoeffCCMG2d"]


def _fine_coefficients(mg, coeffs):
    """A copy of `coeffs` on the MG's finest level frame (ghosts zero).

    The solvers pass coefficients of a grid with a different ghost count
    (ng=4); only the valid region is used."""
    g = mg.grids[-1]
    c_in = torch.as_tensor(coeffs, dtype=mg.dtype, device=mg.device)
    if tuple(c_in.shape) == (g.qx, g.qy):
        return c_in.clone()
    src_ngx = (c_in.shape[0] - mg.nx) // 2
    src_ngy = (c_in.shape[1] - mg.ny) // 2
    if (c_in.shape[0] - 2 * src_ngx != mg.nx or
            c_in.shape[1] - 2 * src_ngy != mg.ny or src_ngx < 0):
        raise IndexError(
            "coefficient array not the same size as multigrid problem")
    c = g.scratch_array(dtype=mg.dtype, device=mg.device)
    c[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1] = \
        c_in[src_ngx:src_ngx + mg.nx, src_ngy:src_ngy + mg.ny]
    return c


class VarCoeffCCMG2d(MG.CellCenterMG2d):
    """Multigrid with a cell-centered variable coefficient eta."""

    def __init__(self, nx, ny, xmin=0.0, xmax=1.0, ymin=0.0, ymax=1.0,
                 xl_BC_type="dirichlet", xr_BC_type="dirichlet",
                 yl_BC_type="dirichlet", yr_BC_type="dirichlet",
                 nsmooth=10, nsmooth_bottom=50,
                 verbose=0, coeffs=None, coeffs_bc=None,
                 true_function=None, *, device=None, dtype=None):
        super().__init__(nx, ny, ng=1,
                         xmin=xmin, xmax=xmax, ymin=ymin, ymax=ymax,
                         xl_BC_type=xl_BC_type, xr_BC_type=xr_BC_type,
                         yl_BC_type=yl_BC_type, yr_BC_type=yr_BC_type,
                         alpha=0.0, beta=0.0,
                         nsmooth=nsmooth, nsmooth_bottom=nsmooth_bottom,
                         verbose=verbose,
                         aux_field=["coeffs"], aux_bc=[coeffs_bc],
                         true_function=true_function, device=device,
                         dtype=dtype)

        self.set_coefficients(coeffs, coeffs_bc)

    def set_coefficients(self, coeffs, coeffs_bc):
        """Install the fine-level coefficients and restrict them down: the
        cell-centred chain (aux "coeffs"), and each level's edge planes,
        new tensors (ShardedVarCoeffMG.install_coefficients calls it before
        each of lm_atm's sharded solves)."""
        fine = self.nlevels - 1
        c = self.aux["coeffs"]
        c[fine] = fill_ghost(_fine_coefficients(self, coeffs),
                             self.grids[fine], coeffs_bc)
        edges = [ec.EdgeCoeffs(self.grids[fine], c[fine])]
        for n in range(self.nlevels - 2, -1, -1):
            cc = restrict_array(c[n + 1], self.grids[n + 1], self.grids[n])
            c[n] = fill_ghost(cc, self.grids[n], coeffs_bc)
            edges.insert(0, edges[0].restrict())

        # one (eta_x, eta_y) stack per level; the EdgeCoeffs view it
        self.planes = []
        for e in edges:
            stack = torch.stack([e.x, e.y])
            e.x, e.y = stack[0], stack[1]
            self.planes.append(stack)
        self.edge_coeffs = edges

    # -- operator overrides ------------------------------------------------
    def _smooth_once(self, level, v, f):
        g = self.grids[level]
        exv = ai(self.edge_coeffs[level].x, g)
        eyv = ai(self.edge_coeffs[level].y, g)
        red, black = MG._color_masks(g, v.device)

        def half_sweep(v, mask):
            vv = ai(v, g)
            denom = exv.ip(1) + exv.v() + eyv.jp(1) + eyv.v()
            upd = (-ai(f, g).v() +
                   exv.ip(1) * vv.ip(1) + exv.v() * vv.ip(-1) +
                   eyv.jp(1) * vv.jp(1) + eyv.v() * vv.jp(-1)) / denom
            return torch.where(mask, embed(upd, g), v)

        v = self._fill_v(level, half_sweep(v, red))
        return self._fill_v(level, half_sweep(v, black))

    def _residual(self, level, v, f):
        g = self.grids[level]
        vv = ai(v, g)
        exv = ai(self.edge_coeffs[level].x, g)
        eyv = ai(self.edge_coeffs[level].y, g)

        L_eta_phi = (exv.ip(1) * (vv.ip(1) - vv.v()) -
                     exv.v() * (vv.v() - vv.ip(-1)) +
                     eyv.jp(1) * (vv.jp(1) - vv.v()) -
                     eyv.v() * (vv.v() - vv.jp(-1)))
        return embed(ai(f, g).v() - L_eta_phi, g)
