"""Carry a simulation's parameters and state into the port.

This system has no weights: a run is its runtime parameters plus its state
stack.  `carry` takes both as plain Python/numpy values -- for example a
JAX simulation's `rp.params` and `numpy.asarray(sim.cc_data.data)` -- and
returns the port's RuntimeParameters and a state tensor on the given device
and dtype, so both packages can be set to identical inputs.  As every entry
point, they run on CUDA unless the caller passes ``device="cpu"``, and the
dtype defaults to float32 on CUDA and float64 on the CPU
(pyro2_tpu_torch.defaults).
`carry_simulation` goes one step further and returns a live, initialized
Simulation of the port (any solver of pyro_sim.valid_solvers) holding that
state as it stands: the state of a
4th-order (FV2d) solver is a stack of cell averages, so `preevolve`, which
converts centers to averages, is not run again.  For lm_atm it also takes
the base state (`base`: the rho0, p0, beta0 and beta0-edges profiles as
arrays), which belongs to the run as much as the state does.
`carry_block` hands one rank of a sharded run its block of a global array,
for example `numpy.asarray` of a JAX array sharded over a ("x", "y") mesh.
"""

import importlib

import numpy as np
import torch

from pyro2_tpu_torch import defaults
from pyro2_tpu_torch.util.runparams import RuntimeParameters

__all__ = ["carry", "carry_block", "carry_simulation"]


def carry(params, state, *, device=None, dtype=None):
    """(RuntimeParameters, state tensor) from a parameter dict and a
    (nvar, qx, qy) array, on `device` (CUDA by default, raising without a
    GPU) in `dtype` (defaults.dtype)."""
    device = defaults.resolve_device(device)
    dtype = defaults.dtype(device, dtype)
    rp = RuntimeParameters()
    rp.params = dict(params)
    rp.param_comments = {k: "" for k in rp.params}
    U = torch.as_tensor(np.array(state, dtype=np.float64),
                        dtype=dtype, device=device).contiguous()
    return rp, U


def carry_simulation(solver_name, problem_name, params, state, *, t=0.0,
                     n=0, extra_vars=None, base=None, device=None,
                     dtype=None):
    """An initialized Simulation of `solver_name` whose parameters are
    `params` and whose state is `state` at time t after n steps (the
    problem's initial conditions are set and then replaced); `base` maps
    the names of lm_atm's base-state profiles to their arrays."""
    device = defaults.resolve_device(device)
    dtype = defaults.dtype(device, dtype)
    rp, U = carry(params, state, device=device, dtype=dtype)
    solver = importlib.import_module(f"pyro2_tpu_torch.solvers.{solver_name}")
    problem = importlib.import_module(
        f"pyro2_tpu_torch.solvers.{solver_name}.problems.{problem_name}")
    sim = solver.Simulation(
        solver_name, problem_name, problem.init_data, rp,
        problem_finalize_func=problem.finalize,
        problem_source_func=getattr(problem, "source_terms", None),
        problem_source_weight_func=getattr(problem, "source_weight", None),
        device=device, dtype=dtype)
    if extra_vars:
        sim.initialize(extra_vars=extra_vars)
    else:
        sim.initialize()
    if tuple(U.shape) != tuple(sim.cc_data.data.shape):
        raise ValueError(f"state shape {tuple(U.shape)} does not fit the "
                         f"simulation's {tuple(sim.cc_data.data.shape)}")
    sim.cc_data.set_vars(U)
    for name, profile in (base or {}).items():
        b = sim.base[name]
        if np.shape(profile) != b.d.shape:
            raise ValueError(f"base state {name}: shape {np.shape(profile)} "
                             f"does not fit {b.d.shape}")
        b.d[:] = np.asarray(profile, dtype=np.float64)
    sim.cc_data.t = t
    sim.n = n
    return sim


def carry_block(array, mesh, *, dtype=torch.float64):
    """This rank's block of a global (..., nx, ny) array -- the layout of
    the JAX package's arrays sharded P(..., "x", "y") -- as a contiguous
    tensor on the mesh's device (parallel.mesh_comm.Mesh)."""
    a = np.asarray(array, dtype=np.float64)
    nx, ny = a.shape[-2:]
    if nx % mesh.px or ny % mesh.py:
        raise ValueError(f"a ({nx}, {ny}) array does not split over a "
                         f"{mesh.px} x {mesh.py} mesh")
    bx, by = nx // mesh.px, ny // mesh.py
    blk = a[..., mesh.ix * bx:(mesh.ix + 1) * bx,
            mesh.iy * by:(mesh.iy + 1) * by]
    return torch.as_tensor(np.ascontiguousarray(blk), dtype=dtype,
                           device=mesh.device)
