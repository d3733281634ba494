"""pyro2_tpu_torch -- the PyTorch/CUDA port of pyro2_tpu.

The JAX package `pyro2_tpu` stays the reference; this package keeps its
module layout and names.  Plain tensor code is PyTorch, and the JAX
package's Pallas TPU kernels become CUDA kernels written for Hopper (sm_90a)
under `csrc/`.  Entry points run on CUDA unless the caller passes
device="cpu":

    from pyro2_tpu_torch import Pyro
    p = Pyro("compressible")                 # or Pyro(..., device="cpu")
    p.initialize_problem("quad", inputs_dict={"mesh.nx": 256,
                                              "mesh.ny": 256})
    p.run_sim()
    dens = p.get_var("density")

Ported so far: the compressible CTU solver (Cartesian and spherical
geometry), the constant-coefficient multigrid with its consumers
(diffusion, incompressible, burgers, burgers_viscous and
incompressible_viscous), the method-of-lines tier (compressible_rk,
compressible_fv4, compressible_sdc), the shallow-water solver (swe), and
the coefficient multigrid with the low-Mach atmosphere solver (lm_atm),
with the layers under them; ROADMAP.md lists what waits.  A state
container built by hand (CellCenterData2d, Grid2d.scratch_array) also
lands on CUDA unless given device="cpu".
"""

from pyro2_tpu_torch.mesh.boundary import BC, bc_is_solid, define_bc
from pyro2_tpu_torch.mesh.grid import Cartesian2d, Grid2d, SphericalPolar
from pyro2_tpu_torch.mesh.patch import CellCenterData2d
from pyro2_tpu_torch.pyro_sim import Pyro
from pyro2_tpu_torch.util.runparams import RuntimeParameters

__version__ = "0.1.0"

__all__ = [
    "BC", "bc_is_solid", "define_bc",
    "Grid2d", "Cartesian2d", "SphericalPolar",
    "CellCenterData2d", "Pyro", "RuntimeParameters",
]
