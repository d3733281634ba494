#!/usr/bin/env python3
"""Convergence summary from >= 3 output files at resolutions differing by a
constant factor: prints a rate table and saves a log-log error plot with the
theoretical-order slope for comparison (the port of
pyro2_tpu/analysis/convergence_plot.py).

usage: python -m pyro2_tpu_torch.analysis.convergence_plot [--device cpu] \\
           fine ... coarse [-o out.pdf] [-n order] [-r resolution_factor] \\
           [-v variable]
Files are given from FINEST to COARSEST.
"""

import argparse
import sys

import numpy as np

from pyro2_tpu_torch.analysis import add_device_argument, convergence, read


def convergence_errors(files, var_name="density", res_factor=2,
                       device=None):
    """Richardson errors between successive resolutions.

    Returns (nx list, L2-error list), one entry per coarse file: the error
    of each file against its next-finer neighbor restricted onto it.
    """
    sims = [read(f, device) for f in files]
    data = [s.cc_data if hasattr(s, "cc_data") else s for s in sims]
    for fine, coarse in zip(data, data[1:]):
        if fine.grid.nx != res_factor * coarse.grid.nx:
            raise ValueError(
                f"resolutions must differ by x{res_factor}: got "
                f"{fine.grid.nx} vs {coarse.grid.nx}")
    nxs, errors = [], []
    for fine, coarse in zip(data, data[1:]):
        _, l2 = convergence.compare(fine, coarse, var_name, res_factor)
        nxs.append(coarse.grid.nx)
        errors.append(l2)
    return nxs, errors


def convergence_plot(nxs, errors, fname=None, order=2):
    """Print the rate table; optionally save a log-log plot."""
    print(f"{'nx':>8} {'L2 error':>14} {'measured rate':>14}")
    for i, (nx, err) in enumerate(zip(nxs, errors)):
        if i == 0:
            print(f"{nx:>8} {err:>14.6g} {'—':>14}")
        else:
            rate = np.log(err / errors[i - 1]) / np.log(nxs[i - 1] / nx)
            print(f"{nx:>8} {err:>14.6g} {rate:>14.3f}")

    if fname is not None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        nxs = np.asarray(nxs, dtype=float)
        errors = np.asarray(errors)
        fig, ax = plt.subplots()
        ax.loglog(nxs, errors, "o-", label="measured error")
        ax.loglog(nxs, errors[0] * (nxs[0] / nxs) ** order, "--",
                  label=f"O(N^-{order})")
        ax.set_xlabel("nx")
        ax.set_ylabel("L2 error (Richardson)")
        ax.legend()
        fig.tight_layout()
        fig.savefig(fname)
        print(f"wrote {fname}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input_file", nargs="+",
                   help="outputs from finest to coarsest (>= 3 files)")
    p.add_argument("-o", "--out", default="convergence_plot.pdf")
    p.add_argument("-n", "--order", default=2, type=int,
                   help="theoretical order of convergence")
    p.add_argument("-r", "--resolution", default=2, type=int,
                   help="resolution factor between successive files")
    p.add_argument("-v", "--variable", default="density")
    add_device_argument(p)
    args = p.parse_args(argv)

    if len(args.input_file) < 3:
        sys.exit("at least 3 input files are required")

    nxs, errors = convergence_errors(args.input_file, args.variable,
                                     args.resolution, args.device)
    convergence_plot(nxs, errors, fname=args.out, order=args.order)


if __name__ == "__main__":
    main()
