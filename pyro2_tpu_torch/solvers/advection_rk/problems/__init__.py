"""Problems shared with the base advection solver (re-exported)."""
import importlib
import sys

from pyro2_tpu_torch.solvers.advection import problems as _base

for _name in _base.__all__:
    sys.modules[__name__ + "." + _name] = importlib.import_module(
        "pyro2_tpu_torch.solvers.advection.problems." + _name)

__all__ = _base.__all__
