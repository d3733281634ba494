"""4th-order finite-volume compressible Simulation.

The port of pyro2_tpu/solvers/compressible_fv4/simulation.py: FV2d cell
averages, sources evaluated at centers and converted back to averages, and
the RK evolve of compressible_rk.  `build_substep` is the plain stage
increment; `evolve` runs it through the MOL kernel's wrapper
(mol_kernel.MOLSubstep, kind "fv4").
"""

import numpy as np

import pyro2_tpu_torch.solvers.compressible_fv4.fluxes as flx
from pyro2_tpu_torch.mesh import fv
from pyro2_tpu_torch.mesh.fv import to_centers_array
from pyro2_tpu_torch.mesh.indexer import ai, embed
from pyro2_tpu_torch.solvers import compressible_rk
from pyro2_tpu_torch.solvers.compressible import get_external_sources
from pyro2_tpu_torch.solvers.compressible_rk.simulation import (_floored,
                                                                _sponge)

__all__ = ["build_substep", "Simulation"]


def build_substep(myg, rp, ivars, problem_source=None):
    """The plain fv4 stage increment substep(U, t, dt) -> k on a grid: k
    is zero on the ghosts, and U is not modified."""
    small_dens = rp.get_param("compressible.small_dens")
    do_sponge = rp.get_param("sponge.do_sponge")

    class _Data:
        grid = myg

    my_data = _Data()

    def substep(U, t, dt):
        U = _floored(U, small_dens, ivars, myg)

        # sources at centers, converted back to averages
        U_cc = to_centers_array(U, myg)
        S = get_external_sources(t, dt, U_cc, ivars, rp, myg,
                                 problem_source=problem_source)
        S = S + embed(-myg.dx ** 2 * ai(S, myg).lap() / 24.0, myg)

        F_x, F_y = flx.fluxes(U, my_data, rp, ivars)
        Fx = ai(F_x, myg)
        Fy = ai(F_y, myg)
        k_v = ((Fx.v() - Fx.ip(1)) / myg.dx +
               (Fy.v() - Fy.jp(1)) / myg.dy + ai(S, myg).v())

        if do_sponge:
            k_v = _sponge(k_v, U, ivars, rp, myg)

        return embed(k_v, myg)

    return substep


class Simulation(compressible_rk.Simulation):
    """The 4th-order (McCorquodale & Colella) compressible solver."""

    MOL_KIND = "fv4"

    def data_class(self, grid):
        """Cell-average (FV2d) containers on this simulation's device and
        dtype."""
        return fv.FV2d(grid, dtype=self.dtype, device=self.device)

    def _make_substep(self):
        """The plain stage-increment closure (the kernel's CPU twin)."""
        return build_substep(self.cc_data.grid, self.rp, self.ivars,
                             problem_source=self.problem_source)

    def preevolve(self):
        """Convert the cell-centered ICs to cell averages (dx == dy): one
        ghost fill per variable, then the valid-region conversion."""
        g = self.cc_data.grid
        assert np.abs(g.dx - g.dy) < 1.e-12 * g.dx, \
            "grid cells need to be square"
        for var in self.cc_data.names:
            self.cc_data.from_centers(var)
