"""Carry a simulation's parameters and state into the port.

This system has no weights: a run is its runtime parameters plus its state
stack.  `carry` takes both as plain Python/numpy values -- for example a
JAX simulation's `rp.params` and `numpy.asarray(sim.cc_data.data)` -- and
returns the port's RuntimeParameters and a state tensor on the given device
and dtype, so both packages can be set to identical inputs.
"""

import numpy as np
import torch

from pyro2_tpu_torch.util.runparams import RuntimeParameters

__all__ = ["carry"]


def carry(params, state, *, device="cpu", dtype=torch.float64):
    """(RuntimeParameters, state tensor) from a parameter dict and a
    (nvar, qx, qy) array."""
    rp = RuntimeParameters()
    rp.params = dict(params)
    rp.param_comments = {k: "" for k in rp.params}
    U = torch.as_tensor(np.array(state, dtype=np.float64),
                        dtype=dtype, device=device).contiguous()
    return rp, U
