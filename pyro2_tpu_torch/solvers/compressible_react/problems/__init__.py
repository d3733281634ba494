"""React-specific problems plus the base compressible problems
(re-exported, except rt, which this solver has its own of)."""
import importlib
import sys

from pyro2_tpu_torch.solvers.compressible import problems as _base

for _name in _base.__all__:
    sys.modules[__name__ + "." + _name] = importlib.import_module(
        "pyro2_tpu_torch.solvers.compressible.problems." + _name)

__all__ = ["flame", "rt"] + [n for n in _base.__all__ if n != "rt"]
