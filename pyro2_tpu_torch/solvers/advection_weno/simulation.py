"""WENO advection Simulation (the port of
pyro2_tpu/solvers/advection_weno/simulation.py): the RK driver of
advection_rk with WENO fluxes."""

from pyro2_tpu_torch.solvers import advection_rk
from pyro2_tpu_torch.solvers.advection_weno import fluxes as flx


class Simulation(advection_rk.Simulation):

    @property
    def flux_fn(self):
        return flx.fluxes
