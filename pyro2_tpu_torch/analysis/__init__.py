"""Post-processing and verification CLIs: the port of pyro2_tpu/analysis/.

Each module reads pyro outputs (either package's) through util.io_pyro.read
in float64, the files' precision, on the device its main() takes with
--device (the port's default, the card, when none is given), and does its
arithmetic in numpy on the values brought back with .cpu().  matplotlib is
imported inside the plotting functions only: a machine without it runs
every module but the plots.

    python -m pyro2_tpu_torch.analysis.sod_compare --device cpu sod_x_0076.h5
"""

import numpy as np
import torch

__all__ = ["add_device_argument", "as_numpy", "read"]


def as_numpy(x):
    """A tensor on any device, or an array, as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def read(filename, device=None):
    """The output `filename` (a Simulation, or the bare CellCenterData2d of
    a file written without one) read in float64 on `device`."""
    from pyro2_tpu_torch.util import io_pyro

    return io_pyro.read(filename, device=device, dtype=torch.float64)


def add_device_argument(parser):
    """The --device option every main() takes."""
    parser.add_argument(
        "--device", default=None,
        help="device to read the outputs onto (default: the card)")
