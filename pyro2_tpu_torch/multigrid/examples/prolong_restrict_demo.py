#!/usr/bin/env python3
"""Demonstrate the patch restrict / prolong transfer operators by
pretty-printing a small sequentially-numbered grid before and after
(the port of pyro2_tpu/multigrid/examples/prolong_restrict_demo.py)."""

import numpy as np
import torch

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Grid2d


def doit(*, device=None, dtype=None):
    # base grid with sequential interior data
    myg = Grid2d(4, 8, ng=1)
    myd = patch.CellCenterData2d(myg, device=device, dtype=dtype)
    bc = bnd.BC()
    myd.register_var("a", bc)
    myd.create()

    a = np.zeros((myg.qx, myg.qy))
    a[myg.ilo:myg.ihi + 1, myg.jlo:myg.jhi + 1] = \
        np.arange(myg.nx * myg.ny).reshape(myg.nx, myg.ny)
    myd.set_var("a", a)

    print("restriction test")
    print("original (fine) array")
    myd.pretty_print("a")

    cg = Grid2d(2, 4, ng=1)
    cd = patch.CellCenterData2d(cg, device=myd.device, dtype=myd.dtype)
    cd.register_var("a", bc)
    cd.create()
    cd.set_var("a", myd.restrict("a"))

    print("\nrestricted array")
    cd.pretty_print("a")

    print("\nprolongation test")
    print("original (coarse) array w/ ghost cells")
    cd.set_var("a", torch.arange(cg.qx * cg.qy, dtype=cd.dtype)
               .reshape(cg.qx, cg.qy))
    cd.pretty_print("a")

    print("\nprolonged array")
    fd = patch.CellCenterData2d(myg, device=myd.device, dtype=myd.dtype)
    fd.register_var("a", bc)
    fd.create()
    fd.set_var("a", cd.prolong("a"))
    fd.pretty_print("a", fmt="%7.3f")


if __name__ == "__main__":
    doit()
