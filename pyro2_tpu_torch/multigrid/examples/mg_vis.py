#!/usr/bin/env python3
"""Visualize multigrid convergence: solve the simple Poisson problem
cycle-by-cycle and plot the solution, the residual field, and the
residual-error history after each V-cycle (the port of
pyro2_tpu/multigrid/examples/mg_vis.py; each frame is one full cycle of
mg_kernel.cycle).  It needs matplotlib, which the GPU machine lacks, so
it runs on the CPU (device="cpu")."""

import torch

from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.multigrid import MG, mg_kernel
from pyro2_tpu_torch.multigrid.examples.mg_test_simple import f, true


def doit(nx, ny, *, rtol=1.e-11, store_frames=True, prefix="mg_vis",
         device=None, dtype=None):
    """Drive one V-cycle at a time, plotting a frame after each."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a = MG.CellCenterMG2d(nx, ny,
                          xl_BC_type="dirichlet", yl_BC_type="dirichlet",
                          xr_BC_type="dirichlet", yr_BC_type="dirichlet",
                          verbose=0, device=device, dtype=dtype)
    a.init_zeros()
    a.init_RHS(f(a.x2d, a.y2d))

    g = a.soln_grid
    interior = (slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
    history = []
    cycle = 0
    residual_error = 1.e33
    while residual_error > rtol and cycle < a.max_cycles:
        cycle += 1
        v, r = mg_kernel.cycle(a, a.v[-1], a.f[-1])
        a.v[-1] = v
        a.r[-1] = r
        rnorm = float(ai(r, g).norm())
        residual_error = rnorm / a.source_norm \
            if a.source_norm != 0.0 else rnorm
        history.append(residual_error)
        print(f"cycle {cycle}: residual err = {residual_error:g}")

        if store_frames:
            fig, axes = plt.subplots(1, 3, figsize=(12, 3.6))
            im0 = axes[0].imshow(v.cpu().numpy()[interior].T,
                                 origin="lower",
                                 extent=[a.xmin, a.xmax, a.ymin, a.ymax])
            axes[0].set_title(f"v after cycle {cycle}")
            fig.colorbar(im0, ax=axes[0])
            im1 = axes[1].imshow(r.cpu().numpy()[interior].T,
                                 origin="lower",
                                 extent=[a.xmin, a.xmax, a.ymin, a.ymax])
            axes[1].set_title("residual")
            fig.colorbar(im1, ax=axes[1])
            axes[2].semilogy(range(1, len(history) + 1), history, "o-")
            axes[2].set_xlabel("V-cycle")
            axes[2].set_ylabel("||r|| / ||f||")
            axes[2].set_title("convergence")
            fig.tight_layout()
            fig.savefig(f"{prefix}_{cycle:02d}.png", dpi=110)
            plt.close(fig)

        if len(history) >= 2 and history[-1] > 0.95 * history[-2]:
            break  # working-precision floor

    a.num_cycles = cycle
    a.residual_error = residual_error
    a.v[-1] = a._fill_v(a.nlevels - 1, a.v[-1])

    e = a.get_solution() - torch.as_tensor(true(a.x2d, a.y2d),
                                           dtype=a.dtype, device=a.device)
    enorm = float(ai(e, g).norm())
    print(f"L2 error from true solution = {enorm:g} after {cycle} cycles")
    return history


if __name__ == "__main__":
    doit(64, 64, device="cpu")
