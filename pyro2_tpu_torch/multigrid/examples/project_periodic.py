#!/usr/bin/env python3
"""Cell-centered approximate-projection demo with periodic BCs.

Start from the divergence-free Almgren-Bell-Szymczak velocity field
    u = -sin^2(pi x) sin(2 pi y),  v = sin^2(pi y) sin(2 pi x),
pollute it with the gradient of a Gaussian scalar, then project (solve
L phi = div U with periodic MG and subtract grad phi) until the original
field is recovered.  Because the projection is approximate, several
iterations are needed -- this demo runs `nproj` of them and reports how the
residual divergence and the error vs the original field shrink (the port
of pyro2_tpu/multigrid/examples/project_periodic.py; the HDF5 file is
written by the port's util/hdf5.py)."""

import numpy as np
import torch.nn.functional as F

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d


def doit(nx, ny, nproj=2, *, verbose=0, device=None, dtype=None):
    """Run the projection demo; returns per-iteration ||div U|| values."""
    myg = Grid2d(nx, ny, ng=1)

    bc = bnd.BC(xlb="periodic", xrb="periodic",
                ylb="periodic", yrb="periodic")
    U = patch.CellCenterData2d(myg, device=device, dtype=dtype)
    for name in ["u-old", "v-old", "u+gphi", "v+gphi", "u", "v", "divU",
                 "phi-old", "phi", "dphi",
                 "gradphi_x-old", "gradphi_y-old", "gradphi_x", "gradphi_y"]:
        U.register_var(name, bc)
    U.create()

    # divergence-free ABS96 field
    u0 = -(np.sin(np.pi * myg.x2d) ** 2) * np.sin(2.0 * np.pi * myg.y2d)
    v0 = (np.sin(np.pi * myg.y2d) ** 2) * np.sin(2.0 * np.pi * myg.x2d)
    U.set_var("u-old", u0)
    U.set_var("v-old", v0)

    # pollute with grad of a Gaussian (normal component ~0 on boundaries)
    R, x0, y0 = 0.1, 0.5, 0.5
    phi0 = np.exp(-((myg.x2d - x0) ** 2 + (myg.y2d - y0) ** 2) / R ** 2)
    gpx = phi0 * (-2.0 * (myg.x2d - x0) / R ** 2)
    gpy = phi0 * (-2.0 * (myg.y2d - y0) / R ** 2)
    U.set_var("phi-old", phi0)
    U.set_var("gradphi_x-old", gpx)
    U.set_var("gradphi_y-old", gpy)

    U.set_var("u+gphi", u0 + gpx)
    U.set_var("v+gphi", v0 + gpy)
    U.set_var("u", u0 + gpx)
    U.set_var("v", v0 + gpy)
    U.fill_BC_all()

    def divergence(uu, vv):
        au, av = ai(uu, myg), ai(vv, myg)
        return (0.5 * (au.ip(1) - au.ip(-1)) / myg.dx +
                0.5 * (av.jp(1) - av.jp(-1)) / myg.dy)

    def pad(a):
        return F.pad(a, (myg.ng,) * 4)

    a = CellCenterMG2d(nx, ny,
                       xl_BC_type="periodic", xr_BC_type="periodic",
                       yl_BC_type="periodic", yr_BC_type="periodic",
                       verbose=verbose, device=U.device, dtype=U.dtype)

    interior = (slice(myg.ilo, myg.ihi + 1), slice(myg.jlo, myg.jhi + 1))
    div_norms = []
    for iproj in range(nproj):
        u = U.get_var("u")
        v = U.get_var("v")
        divU = divergence(u, v)
        div_norms.append(float(ai(pad(divU), myg).norm()))

        a.init_zeros()
        a.init_RHS(pad(divU))
        a.solve(rtol=1.e-12)

        U.set_var("phi", a.get_solution(grid=myg))
        U.fill_BC("phi")
        aphi = ai(U.get_var("phi"), myg)
        gx = 0.5 * (aphi.ip(1) - aphi.ip(-1)) / myg.dx
        gy = 0.5 * (aphi.jp(1) - aphi.jp(-1)) / myg.dy

        u_new, v_new = u.clone(), v.clone()
        u_new[interior] -= gx
        v_new[interior] -= gy
        U.set_var("u", u_new)
        U.set_var("v", v_new)
        U.fill_BC("u")
        U.fill_BC("v")
        U.set_var("gradphi_x", pad(gx))
        U.set_var("gradphi_y", pad(gy))

        err = float(ai(U.get_var("u") - U.get_var("u-old"), myg).norm())
        print(f"projection {iproj + 1}: ||div U|| before = "
              f"{div_norms[-1]:.6g}, ||u - u_orig|| after = {err:.6g}")

    U.write("project-periodic")
    return div_norms


if __name__ == "__main__":
    doit(128, 128)
