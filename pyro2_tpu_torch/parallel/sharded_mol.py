"""The method-of-lines compressible solvers over a mesh of ranks.

The port of pyro2_tpu/parallel/sharded_mol.py: compressible_rk,
compressible_fv4 and compressible_sdc on ShardedSim's machinery (the
block-local Simulation with the block's solid and domain-edge flags,
blockwise initialization, the per-variable halo exchange and the extended
fills, the density floor on the seam halos, the pmin CFL dt).  Only the
step differs: the Butcher-tableau stage loop (mesh/integration.py) or the
SDC node sweep runs in Python on this rank's padded block, with a halo
exchange before each stage increment where the serial evolve calls
fill_BC_all.  Stage starts and the final update add the increments over
the valid region only, with the serial integrator's own arithmetic
(integration._add_valid; the SDC integrals are the serial Simulation's),
so a sharded step equals the serial evolve by bits.

The stage increment is the block-local Simulation's `MOLSubstep`: on CUDA
one `k_rk` launch a stage (with the block's domain-edge flags: a seam's
high faces take their viscosity from the halo, as the serial grid's faces
there do) or one `k_fv4` launch (fv4 and sdc), or it raises; on the CPU
its plain stage with the same flags.  An RK4 step launches 4 kernels, an
SDC step 9 (3 Gauss-Lobatto nodes, 4 sweeps).  Two things of the JAX
package are not carried over: the TPU try/except that falls back to the
jnp stage, and its rk stage without the edge flags, with which every
block zeros the viscosity on its own high faces, seams included (section
C.4 of ROADMAP.md).

fv4 and sdc hold cell averages: `preevolve_interior` converts the blockwise
cell-centre initial state to averages (one halo exchange and
fv.from_centers_array, the serial preevolve's fill and conversion).
"""

import torch.nn.functional as F

from pyro2_tpu_torch.mesh import integration
from pyro2_tpu_torch.mesh.fv import from_centers_array
from pyro2_tpu_torch.parallel.sharded import ShardedSim

__all__ = ["ShardedCompressibleRK", "ShardedCompressibleFV4",
           "ShardedCompressibleSDC"]


class _ShardedMOL(ShardedSim):
    """The stage loop of the MOL tier.  States are this rank's (nvar, bx,
    by) block of the interior; `step` is collective."""

    _SOLVER = None

    def __init__(self, rp, mesh, *, problem="test", ng=4, dtype=None):
        super().__init__(self._SOLVER, rp, mesh, problem=problem, ng=ng,
                         dtype=dtype)

    def _valid_sl(self):
        g = self.local_grid
        return (slice(None), slice(g.ilo, g.ihi + 1),
                slice(g.jlo, g.jhi + 1))

    def _increment(self, Us, t, dt):
        """The stage increment k of a filled padded stage state (one
        kernel launch on CUDA)."""
        return self._block_step(self._floor_seams(Us), t, dt)

    def step(self, U_int, t, dt):
        """One sharded RK step of this rank's (nvar, bx, by) interior block
        (t, dt: host floats)."""
        method = self.rp.get_param("compressible.temporal_method")
        A, B, C = (integration.a[method], integration.b[method],
                   integration.c[method])
        g = self.local_grid
        ng = self.ng
        U0 = F.pad(U_int, (ng, ng, ng, ng))
        ks = []
        for s in range(len(B)):
            Us = U0.clone()
            for j in range(s):
                coeff = dt * A[s, j]
                if coeff != 0.0:
                    integration._add_valid(Us, g, ks[j], coeff)
            ts = t + C[s] * dt
            ks.append(self._increment(self._fill_local(Us, ts), ts, dt))
        for s in range(len(B)):
            coeff = dt * B[s]
            if coeff != 0.0:
                integration._add_valid(U0, g, ks[s], coeff)
        return self._interior(U0)

    def build_step_with_particles(self, particles):
        raise TypeError("the sharded MOL solvers advance no particles; the "
                        "sharded CTU and swe steps do")


class ShardedCompressibleRK(_ShardedMOL):
    _SOLVER = "compressible_rk"


class _ShardedFV4Base(_ShardedMOL):
    """Cell-average (FV2d) solvers: adds the centres -> averages
    preevolve conversion."""

    def preevolve_interior(self, U_int):
        """The sharded fv4 preevolve: this rank's block of cell-centre
        initial values -> cell averages (collective: one exchange)."""
        return self._interior(from_centers_array(self._padded(U_int, None),
                                                 self.local_grid))


class ShardedCompressibleFV4(_ShardedFV4Base):
    _SOLVER = "compressible_fv4"


class ShardedCompressibleSDC(_ShardedFV4Base):
    """SDC node-sweep integration, sharded (3 Gauss-Lobatto nodes, 4
    iterations; 9 stage increments a step)."""

    _SOLVER = "compressible_sdc"

    def step(self, U_int, t, dt):
        """One sharded SDC step of this rank's interior block: the serial
        evolve's sweep, every node state filled by halo exchange."""
        sim = self.local_sim
        sim.dt = dt                        # sdc_integral's dt
        sl = self._valid_sl()
        n_nodes, n_iter = sim.n_nodes, sim.n_iter
        U0 = self._padded(U_int, t)
        A0 = self._increment(U0, t, dt)
        A_kold = [A0] * n_nodes
        A_knew = list(A_kold)
        U_knew = [U0] * n_nodes
        for _ in range(n_iter):
            for m in range(n_nodes):
                if m > 0:
                    A_knew[m] = self._increment(U_knew[m], t, dt)
                if m < n_nodes - 1:
                    integral = sim.sdc_integral(m, m + 1, A_kold)
                    upd = (U_knew[m][sl] +
                           0.5 * dt * (A_knew[m][sl] - A_kold[m][sl]) +
                           integral[sl])
                    new = U_knew[m + 1].clone()
                    new[sl] = upd
                    U_knew[m + 1] = self._fill_local(new, t)
            A_kold = list(A_knew)
        return self._interior(U_knew[-1])
