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

__all__ = ["adopt_block_grid", "adopt_window_grid", "block_grid",
           "blockwise_init_interior", "gather_interior"]


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


def _window_grid(grid_type, ng, rp, shape, shift):
    """The grid of the (shape) window of the global grid whose first
    interior cell is global cell `shift`, from the runtime parameters'
    extents and global shape alone (no global-extent coordinate array is
    built)."""
    return grid_type(shape[0], shape[1], ng=ng,
                     xmin=rp.get_param("mesh.xmin"),
                     xmax=rp.get_param("mesh.xmax"),
                     ymin=rp.get_param("mesh.ymin"),
                     ymax=rp.get_param("mesh.ymax"),
                     _coord_shift=shift,
                     _domain_n=(rp.get_param("mesh.nx"),
                                rp.get_param("mesh.ny")))


def _rank_block_grid(grid_type, ng, rp, mesh):
    """This rank's block grid."""
    nx, ny = rp.get_param("mesh.nx"), rp.get_param("mesh.ny")
    bx, by = nx // mesh.px, ny // mesh.py
    return _window_grid(grid_type, ng, rp, (bx, by),
                        (mesh.ix * bx, mesh.iy * by))


def adopt_window_grid(grid, rp, shift):
    """Make a grid the window grid of its own shape at global cell
    `shift`, in place: the global extents, the global dx and dy and the
    bitwise-global coordinates and geometry of the window.  A grid built
    from the window's own extents can have a dx an ulp off the global
    one."""
    bg = _window_grid(type(grid), grid.ng, rp, (grid.nx, grid.ny), shift)
    grid.__dict__.pop("_tensors", None)
    grid.__dict__.update(bg.__dict__)
    return grid


def adopt_block_grid(grid, rp, mesh):
    """Make a block-sized grid (a block-local Simulation's) this rank's
    block grid, in place (adopt_window_grid at the block's corner)."""
    nx, ny = rp.get_param("mesh.nx"), rp.get_param("mesh.ny")
    bx, by = nx // mesh.px, ny // mesh.py
    if (bx, by) != (grid.nx, grid.ny):
        raise ValueError("the grid is not this rank's block")
    return adopt_window_grid(grid, rp, (mesh.ix * bx, mesh.iy * by))


def blockwise_init_interior(contract_data, problem_init, rp, mesh, *,
                            dtype=None):
    """This rank's (nvar, bx, by) block of the initial interior:
    `problem_init(block_data, rp)` evaluated on the block grid alone.

    contract_data: any CellCenterData2d (e.g. a block-sized Simulation's)
    supplying the variable / aux registration contract; its grid provides
    only the grid type and ng (the shape comes from rp's mesh.nx / ny and
    the mesh)."""
    gg = contract_data.grid
    bg = _rank_block_grid(type(gg), gg.ng, rp, mesh)
    d = _BlockData(bg, contract_data.names, contract_data.aux,
                   getattr(contract_data, "ivars", None),
                   dtype=working_dtype(mesh.device, dtype),
                   device=mesh.device)
    problem_init(d, rp)
    return d.data[:, bg.ilo:bg.ihi + 1, bg.jlo:bg.jhi + 1].contiguous()


def gather_interior(U, mesh):
    """The (..., nx, ny) global interior from every rank's (..., bx, by)
    block, on every rank (collective)."""
    return mesh.all_gather("y", mesh.all_gather("x", U, U.ndim - 2),
                           U.ndim - 1)
