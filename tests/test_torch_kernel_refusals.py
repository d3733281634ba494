"""Refusals of configurations the CUDA kernels do not cover name their
ROADMAP.md labels: the multigrid kernels' ng = 1 on a square power-of-2
grid (A.30) and the MOL kernels' frame, 4..MAXVAR variables and 4 ghost
cells (A.22).  On the CPU: nothing is compiled, and the multigrid solve
with ng = 2 still runs on its plain route, as the JAX package's does."""

import types

import numpy as np
import pytest

from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.mesh.grid import Cartesian2d
from pyro2_tpu_torch.multigrid import MG, mg_kernel
from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel


@pytest.mark.parametrize("nx,ny,ng", [(16, 16, 2), (24, 24, 1)])
def test_multigrid_check_names_a30(nx, ny, ng):
    mg = MG.CellCenterMG2d(nx, ny, ng=ng, device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.30"):
        mg_kernel.check(mg)
    with pytest.raises(mg_kernel.Ineligible, match=f"not ng={ng} on "
                       f"{nx}x{ny}"):
        mg_kernel.check(mg)


def test_multigrid_ng2_solves_on_the_cpu():
    """The refused frame is a CUDA refusal only: on the CPU the ng = 2
    solve runs the plain route, in the JAX package's cycles to its
    solution."""
    from pyro2_tpu.multigrid import MG as JMG

    kw = dict(ng=2, xl_BC_type="periodic", xr_BC_type="periodic",
              yl_BC_type="periodic", yr_BC_type="periodic")
    mgs = [MG.CellCenterMG2d(32, 32, device="cpu", **kw),
           JMG.CellCenterMG2d(32, 32, **kw)]
    g = mgs[0].soln_grid
    f = np.sin(2 * np.pi * g.x2d) * np.cos(2 * np.pi * g.y2d)
    for mg in mgs:
        mg.init_zeros()
        mg.init_RHS(f)
        mg.solve(rtol=1e-11)
    t, j = mgs
    assert t.num_cycles == j.num_cycles > 1
    np.testing.assert_allclose(np.asarray(t.get_solution()),
                               np.asarray(j.get_solution()), rtol=0,
                               atol=1e-13)


@pytest.mark.parametrize("what", ["ng", "nvar"])
def test_mol_frame_names_a22(what):
    p = Pyro("compressible_rk", device="cpu")
    p.initialize_problem("quad", inputs_dict={"mesh.nx": 16,
                                              "mesh.ny": 16})
    sim = p.sim
    if what == "ng":
        grid = Cartesian2d(16, 16, ng=2)
        ivars = sim.ivars
        match = "4 ghost cells, not 2"
    else:
        grid = sim.cc_data.grid
        ivars = types.SimpleNamespace(**vars(sim.ivars))
        ivars.nvar = mol_kernel.MAXVAR + 1
        match = f"variables, not {mol_kernel.MAXVAR + 1}"
    stub = types.SimpleNamespace(rp=sim.rp, ivars=ivars,
                                 cc_data=types.SimpleNamespace(grid=grid))
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.22"):
        mol_kernel.MOLSubstep(stub, "rk")
    with pytest.raises(NotImplementedError, match=match):
        mol_kernel.MOLSubstep(stub, "fv4")
