"""Spectral-deferred-corrections time integration over the 4th-order
spatial scheme: 3 Gauss-Lobatto nodes, 4 sweeps, Simpson-rule integrals of
the advective term.

The port of pyro2_tpu/solvers/compressible_sdc/simulation.py.  Each node
update replaces the node's state tensor with a new one instead of writing
into it: after the first sweep the old and new containers of a node share
their tensor (as the JAX package shares its immutable arrays), so an
in-place write would reach both.
"""

from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.solvers import compressible_fv4
from pyro2_tpu_torch.util import msg

__all__ = ["Simulation"]


class Simulation(compressible_fv4.Simulation):
    """Drive the 4th-order compressible solver with SDC integration: one
    stage increment (one kernel launch on CUDA) at the first node, then
    two per sweep, 9 per step."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_nodes = 3   # Gauss-Lobatto temporal nodes
        self.n_iter = 4    # SDC iterations for 4th order

    def sdc_integral(self, m_start, m_end, As):
        """Simpson-rule integral of the advective term from node m to m+1."""
        if m_start == 0 and m_end == 1:
            return self.dt / 24.0 * (5.0 * As[0] + 8.0 * As[1] - As[2])
        if m_start == 1 and m_end == 2:
            return self.dt / 24.0 * (-As[0] + 8.0 * As[1] + 5.0 * As[2])
        msg.fail("invalid quadrature range")
        return None

    def evolve(self):
        """One SDC timestep."""
        myd = self.cc_data
        g = myd.grid
        sl = (slice(None), slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))

        U_kold = [patch.cell_center_data_clone(myd) for _ in range(3)]
        U_knew = [U_kold[0],
                  patch.cell_center_data_clone(myd),
                  patch.cell_center_data_clone(myd)]

        A0 = self.substep(U_kold[0])
        A_kold = [A0, A0, A0]
        A_knew = list(A_kold)

        for _ in range(self.n_iter):
            for m in range(self.n_nodes):
                if m > 0:
                    A_knew[m] = self.substep(U_knew[m])
                if m < self.n_nodes - 1:
                    integral = self.sdc_integral(m, m + 1, A_kold)
                    upd = (U_knew[m].data[sl] +
                           0.5 * self.dt * (A_knew[m][sl] - A_kold[m][sl]) +
                           integral[sl])
                    new = U_knew[m + 1].data.clone()
                    new[sl] = upd
                    U_knew[m + 1].data = new
                    U_knew[m + 1].fill_BC_all()

            for m in range(1, self.n_nodes):
                U_kold[m].data = U_knew[m].data
                A_kold[m] = A_knew[m]

        myd.set_vars(U_knew[-1].data)

        if self.particles is not None:
            self.particles.update_particles(
                self.dt, *self.particle_velocity(myd.data))

        myd.t += self.dt
        self.n += 1
