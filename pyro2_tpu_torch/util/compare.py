#!/usr/bin/env python3
"""Zone-by-zone comparison of two CellCenterData2d states.

The port of pyro2_tpu/util/compare.py, the regression oracle: the grids
must match, the variable sets must match, and each variable must pass
numpy.allclose(d1, d2, rtol=rtol) over the valid region, with numpy's
default atol (1e-8), exactly as the JAX package tests its goldens.

usage: python -m pyro2_tpu_torch.util.compare [--device D] file1 file2 [rtol]
"""

import argparse

import numpy as np

from pyro2_tpu_torch.mesh.indexer import ai

errors = {"gridbad": "grids don't agree",
          "namesbad": "variable lists don't agree",
          "varerr": "one or more variables don't agree"}


def _valid(data, name):
    return ai(data.get_var(name), data.grid).v().cpu().numpy()


def compare(data1, data2, rtol=1.e-12):
    """0 if the states agree, else one of the keys of `errors`."""
    if not data1.grid == data2.grid:
        return "gridbad"

    if not sorted(data1.names) == sorted(data2.names):
        return "namesbad"

    print(" ")
    print("variable comparisons:")

    result = 0
    for name in data1.names:
        d1 = _valid(data1, name)
        d2 = _valid(data2, name)

        abs_err = np.max(np.abs(d1 - d2))
        if not np.any(d2 == 0):
            rel_err = np.max(np.abs(d1 - d2) / np.abs(d2))
            print(f"{name:20s} absolute error = {abs_err:10.10g}, "
                  f"relative error = {rel_err:10.10g}")
        else:
            print(f"{name:20s} absolute error = {abs_err:10.10g}")

        if not np.allclose(d1, d2, rtol=rtol):
            result = "varerr"

    return result


def main(argv=None):
    import pyro2_tpu_torch.util.io_pyro as io

    p = argparse.ArgumentParser(
        description="compare two pyro output files zone by zone")
    p.add_argument("--device", default=None,
                   help="torch device to read onto (default: cuda)")
    p.add_argument("file1")
    p.add_argument("file2")
    p.add_argument("rtol", nargs="?", type=float, default=1.e-12)
    args = p.parse_args(argv)

    s1 = io.read(args.file1, device=args.device)
    s2 = io.read(args.file2, device=args.device)

    d1 = s1.cc_data if hasattr(s1, "cc_data") else s1
    d2 = s2.cc_data if hasattr(s2, "cc_data") else s2

    result = compare(d1, d2, args.rtol)

    if result == 0:
        print("SUCCESS: files agree")
    else:
        print("ERROR: ", errors[result])
    return result


if __name__ == "__main__":
    main()
