"""Sharded steps of the scalar hyperbolic families (advection, Burgers).

The port of pyro2_tpu/parallel/sharded_hyperbolic.py.  ShardedSim
(sharded.py) carries the compressible and swe steps with the block's
solid and edge flags, extended BCs and spherical geometry; the scalar
families need none of that.  Their step is a function (fields, dt) ->
fields whose only global coupling is the ghost fill, so the block-local
step without its entry fill (advection's `_build_step(fill_ghosts=False)`,
burgers' `_make_step(fill_ghosts=False)`) runs behind a per-variable halo
exchange, one rank a block.  Plain tensor code on either device: the JAX
package has no TPU kernel for these steps.
"""

import importlib

import torch
import torch.nn.functional as F

from pyro2_tpu_torch.parallel.blocks import (adopt_block_grid,
                                             blockwise_init_interior,
                                             gather_interior)
from pyro2_tpu_torch.parallel.mesh_comm import halo_exchange_stack
from pyro2_tpu_torch.parallel.sharded import block_params

__all__ = ["ShardedAdvection", "ShardedBurgers"]


class _ShardedScalar:
    """The block-local simulation and the halo-exchanged step.  States are
    this rank's (nvar, bx, by) block of the interior, on the mesh's device
    in `dtype` (its working dtype by default); `step` is collective."""

    _SOLVER = None

    def __init__(self, rp, mesh, *, problem, dtype=None):
        self.mesh = mesh
        self.px, self.py = mesh.px, mesh.py
        self.rp = rp
        self.nx, self.ny = rp.get_param("mesh.nx"), rp.get_param("mesh.ny")

        solver_mod = importlib.import_module(
            f"pyro2_tpu_torch.solvers.{self._SOLVER}")
        self._problem_mod = importlib.import_module(
            f"pyro2_tpu_torch.solvers.{self._SOLVER}.problems.{problem}")
        for k, v in getattr(self._problem_mod, "PROBLEM_PARAMS",
                            {}).items():
            if k not in rp.params:
                rp.set_param(k, v, no_new=False)

        self.local_sim = solver_mod.Simulation(
            self._SOLVER, problem, lambda d, r: None, block_params(rp, mesh),
            device=mesh.device, dtype=dtype)
        self.local_sim.initialize()
        self.dtype = self.local_sim.dtype
        self.lg = adopt_block_grid(self.local_sim.cc_data.grid, rp, mesh)
        self.names = list(self.local_sim.cc_data.names)
        self.bcs = [self.local_sim.cc_data.BCs[n] for n in self.names]
        self.ng = self.lg.ng
        self._local = self._local_step()

    def _local_step(self):
        """(filled padded stack, t, dt) -> padded stack, block-local."""
        raise NotImplementedError

    def init_interior(self):
        """This rank's block of the problem's initial state, initialized
        block by block."""
        return blockwise_init_interior(self.local_sim.cc_data,
                                       self._problem_mod.init_data,
                                       self.rp, self.mesh, dtype=self.dtype)

    def gather(self, U_int):
        """The (nvar, nx, ny) global interior from every rank's block, on
        every rank (collective)."""
        return gather_interior(U_int, self.mesh)

    def step(self, U_int, t, dt):
        """One sharded step of this rank's (nvar, bx, by) interior block."""
        ng = self.ng
        U = halo_exchange_stack(F.pad(U_int, (ng, ng, ng, ng)), self.lg,
                                self.bcs, self.mesh)
        return self._local(U, t, dt)[:, ng:-ng, ng:-ng].contiguous()


class ShardedAdvection(_ShardedScalar):
    """Block-partitioned linear advection (CTU): the (1, nx, ny) density
    stack stepped behind a halo exchange."""

    _SOLVER = "advection"

    def _local_step(self):
        one = self.local_sim._build_step(fill_ghosts=False)

        def step(U, t, dt):
            return one(U[0], dt)[None]

        return step


class ShardedBurgers(_ShardedScalar):
    """Block-partitioned inviscid Burgers: the (2, nx, ny) velocity stack
    stepped behind a halo exchange."""

    _SOLVER = "burgers"

    def _local_step(self):
        two = self.local_sim._make_step(fill_ghosts=False)

        def step(U, t, dt):
            return torch.stack(two(U[0], U[1], dt))

        return step
