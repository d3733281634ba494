"""Per-block problem initialization for sharded runs.

The port of pyro2_tpu/parallel/blocks.py: each rank initializes its own
block on a BLOCK grid -- the block's shape, the global domain extents, and
coordinate arrays bitwise equal to the matching window of the global grid
(Grid2d's `_coord_shift` / `_domain_n`) -- so a sharded run never builds
the global state, and a blockwise initial state equals a global one cut
into blocks, bit for bit.
"""

import torch

from pyro2_tpu_torch.defaults import dtype as working_dtype

__all__ = ["block_grid", "blockwise_init_interior"]


def block_grid(global_grid, px, py, ix, iy):
    """The (ix, iy) block's grid on a px x py mesh: block-local shape,
    global extents, bitwise-global coordinate windows."""
    g = global_grid
    assert g.nx % px == 0 and g.ny % py == 0
    bx, by = g.nx // px, g.ny // py
    return type(g)(bx, by, ng=g.ng,
                   xmin=g.xmin, xmax=g.xmax, ymin=g.ymin, ymax=g.ymax,
                   _coord_shift=(ix * bx, iy * by), _domain_n=(g.nx, g.ny))


class _BlockData:
    """Minimal CellCenterData2d stand-in handed to a problem's `init_data`:
    block-local tensors behind the set_var / get_var / aux surface."""

    def __init__(self, grid, names, aux, ivars=None, *, dtype, device):
        self.grid = grid
        self.names = list(names)
        self.aux = dict(aux)
        self.ivars = ivars
        self.t = 0.0
        self.data = torch.zeros((len(self.names), grid.qx, grid.qy),
                                dtype=dtype, device=device)

    def get_var(self, name):
        return self.data[self.names.index(name)]

    def get_var_by_index(self, n):
        return self.data[n]

    def set_var(self, name, arr):
        self.data[self.names.index(name)] = torch.as_tensor(
            arr, dtype=self.data.dtype, device=self.data.device)

    def get_aux(self, key):
        return self.aux.get(key, None)

    def set_aux(self, keyword, value):
        self.aux[keyword] = value

    def set_vars(self, stack):
        self.data = torch.as_tensor(stack, dtype=self.data.dtype,
                                    device=self.data.device).clone()


def blockwise_init_interior(contract_data, problem_init, rp, mesh, *,
                            dtype=None):
    """This rank's (nvar, bx, by) block of the initial interior:
    `problem_init(block_data, rp)` evaluated on the block grid alone.

    contract_data: any CellCenterData2d (e.g. a block-sized Simulation's)
    supplying the variable / aux registration contract; its grid provides
    only the grid type and ng (the shape comes from rp's mesh.nx / ny and
    the mesh)."""
    gg = contract_data.grid
    nx, ny = rp.get_param("mesh.nx"), rp.get_param("mesh.ny")
    bx, by = nx // mesh.px, ny // mesh.py
    # the block grid straight from scalars: no global-extent coordinate
    # array is ever built
    bg = type(gg)(bx, by, ng=gg.ng,
                  xmin=rp.get_param("mesh.xmin"),
                  xmax=rp.get_param("mesh.xmax"),
                  ymin=rp.get_param("mesh.ymin"),
                  ymax=rp.get_param("mesh.ymax"),
                  _coord_shift=(mesh.ix * bx, mesh.iy * by),
                  _domain_n=(nx, ny))
    d = _BlockData(bg, contract_data.names, contract_data.aux,
                   getattr(contract_data, "ivars", None),
                   dtype=working_dtype(mesh.device, dtype),
                   device=mesh.device)
    problem_init(d, rp)
    return d.data[:, bg.ilo:bg.ihi + 1, bg.jlo:bg.jhi + 1].contiguous()
