"""4th-order FV advection Simulation (the port of
pyro2_tpu/solvers/advection_fv4/simulation.py): FV2d (cell-average) data
and the RK evolve of advection_rk."""

from pyro2_tpu_torch.mesh import fv
from pyro2_tpu_torch.simulation_null import bc_setup, grid_setup
from pyro2_tpu_torch.solvers import advection_rk
from pyro2_tpu_torch.solvers.advection_fv4 import fluxes as flx


class Simulation(advection_rk.Simulation):

    def initialize(self):
        """FV2d data (cell averages), ng=4."""
        my_grid = grid_setup(self.rp, ng=4)
        my_data = fv.FV2d(my_grid, dtype=self.dtype, device=self.device)
        bc = bc_setup(self.rp)[0]
        my_data.register_var("density", bc)
        my_data.create()
        self.cc_data = my_data
        self.init_particles(bc)

        self.problem_func(self.cc_data, self.rp)

    @property
    def flux_fn(self):
        return flx.fluxes

    def preevolve(self):
        """ICs were set at cell-centers; convert to cell-averages."""
        for var in self.cc_data.names:
            self.cc_data.from_centers(var)
