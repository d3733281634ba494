#!/usr/bin/env python3
"""Richardson convergence: restrict a fine output onto a coarse one and
report the error norms (the port of pyro2_tpu/analysis/convergence.py).

    python -m pyro2_tpu_torch.analysis.convergence [--device cpu] \\
        fine.h5 coarse.h5 [variable_name=density] [N=2]
"""

import argparse

import numpy as np

from pyro2_tpu_torch.analysis import add_device_argument, as_numpy, read
from pyro2_tpu_torch.mesh.indexer import ai

usage = """
      usage: python -m pyro2_tpu_torch.analysis.convergence [--device DEV] \\
                 fine coarse [variable_name=density] [N=2]
"""


def compare(fine, coarse, var_name, N):
    """(inf-norm, L2-norm) of coarse - restrict(fine): the restriction on
    the containers' device, the norms in numpy."""
    cg = coarse.grid
    var = as_numpy(ai(coarse.get_var(var_name), cg).v())
    var_avg = as_numpy(ai(fine.restrict(var_name, N=N), cg).v())
    e = var - var_avg
    l2 = float(np.sqrt(cg.dx * cg.dy * np.sum(e ** 2)))
    return float(np.abs(e).max()), l2


def main(argv=None):
    p = argparse.ArgumentParser(usage=usage)
    p.add_argument("fine")
    p.add_argument("coarse")
    p.add_argument("variable", nargs="?", default="density")
    p.add_argument("N", nargs="?", default=2, type=int)
    add_device_argument(p)
    args = p.parse_args(argv)

    ff = read(args.fine, args.device)
    cc = read(args.coarse, args.device)
    result = compare(ff.cc_data, cc.cc_data, args.variable, args.N)
    print(f"inf norm and L2 norm of {args.variable}: ", result)


if __name__ == "__main__":
    main()
