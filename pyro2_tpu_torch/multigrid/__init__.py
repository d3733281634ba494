"""Cell-centered multigrid (the port of pyro2_tpu.multigrid): the
constant-coefficient solver `MG.CellCenterMG2d` and its CUDA V-cycle
kernels (`mg_kernel`)."""

from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d
