#!/usr/bin/env python3
"""Verify the shock speed of the inviscid Burgers solver from two states
of the ``test`` problem (the port of
pyro2_tpu/solvers/burgers/problems/verify.py).

The test problem sets up a diagonal shock with (u, v) = (2, 2) ahead of
(0, 0); the reference uses ``sqrt(8)`` as the theoretical speed of the |U|
front.  `front_speed` locates the front (where the diagonal-averaged |U|
first drops below 0.9 S) in each of two CellCenterData2d states and
returns the measured front speed beside the theoretical one; `verify`
reads the two states from output files with util/io_pyro.read.

usage: python -m pyro2_tpu_torch.solvers.burgers.problems.verify \
           [--device D] file1 file2
"""

import argparse

import numpy as np

import pyro2_tpu_torch.util.io_pyro as io


def _diag_profile(myd):
    """Diagonal-averaged |U| on the half-cell diagonal coordinate grid."""
    myg = myd.grid
    u = myd.get_var("x-velocity").cpu().numpy()
    v = myd.get_var("y-velocity").cpu().numpy()
    sl = (slice(myg.ilo, myg.ihi + 1), slice(myg.jlo, myg.jhi + 1))
    uv = np.sqrt(u[sl] ** 2 + v[sl] ** 2)

    nx = myg.nx
    averages = []
    for n in range(-(nx - 1), nx):
        averages.append(np.diagonal(np.flipud(uv), n).mean())

    grid = myg.x[myg.ilo:myg.ihi + 1]
    x = [grid[0]]
    for xr in grid[1:]:
        x.append(0.5 * (x[-1] + xr))
        x.append(xr)
    return np.asarray(x), np.asarray(averages)


def _front_position(x, uv, threshold):
    idx = np.flatnonzero(uv < threshold)
    if idx.size == 0:
        raise RuntimeError("no shock front found (|U| never drops below "
                           f"{threshold:g})")
    return x[idx[0]]


def front_speed(d1, d2, *, verbose=True):
    """(measured, theoretical) speed of the |U| front between two states
    of the test problem, d2 the later one."""
    dt = d2.t - d1.t
    if dt <= 0.0:
        raise RuntimeError("the second state must be later than the first")

    shock_speed_theo = np.sqrt(2.0 * 2.0 + 2.0 * 2.0)
    threshold = 0.9 * shock_speed_theo

    x1, uv1 = _diag_profile(d1)
    x2, uv2 = _diag_profile(d2)

    pos1 = _front_position(x1, uv1, threshold)
    pos2 = _front_position(x2, uv2, threshold)

    # the front moves along the diagonal; positions are in the x
    # projection, so the diagonal distance is sqrt(2) * dx_projection
    shock_speed = np.sqrt(2.0) * (pos2 - pos1) / dt

    if verbose:
        print(f"front at t={d1.t:g}: x={pos1:g}; t={d2.t:g}: x={pos2:g}")
        print(f"measured shock speed:    {shock_speed:g}")
        print(f"theoretical shock speed: {shock_speed_theo:g}")
        print(f"relative error:          "
              f"{abs(shock_speed - shock_speed_theo) / shock_speed_theo:g}")
    return shock_speed, shock_speed_theo


def verify(file1, file2, *, device=None):
    """The front speed between two output files of the test problem (read
    onto `device`, CUDA by default)."""
    d1 = io.read(file1, device=device).cc_data
    d2 = io.read(file2, device=device).cc_data
    return front_speed(d1, d2)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="shock speed of the burgers test problem between two "
                    "output files")
    p.add_argument("--device", default=None,
                   help="torch device to read onto (default: cuda)")
    p.add_argument("file1")
    p.add_argument("file2")
    args = p.parse_args(argv)
    return verify(args.file1, args.file2, device=args.device)


if __name__ == "__main__":
    main()
