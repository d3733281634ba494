"""Massless Lagrangian tracer particles as one (N, 2) position tensor.

The port of pyro2_tpu/particles/particles.py.  The positions, the initial
positions and the `active` mask live on the simulation data's device in its
dtype.  The bilinear velocity interpolation is one gather; the midpoint
(RK2) advance and the per-edge boundary enforcement (periodic wrap,
reflection, outflow) are masked tensor operations with no host read, so
the on-device loop (driver_loop.py) can carry them through a CUDA graph.
An outflow or neumann edge marks a particle inactive; it keeps its
position and its row.  Plain tensor code: the JAX package computes all of
this outside any Pallas kernel.
"""

import numpy as np
import torch

from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.util import msg

__all__ = ["Particles"]

_OUT = ("outflow", "neumann")
_REFLECT = ("reflect-even", "reflect-odd", "dirichlet")


class Particles:
    """A collection of tracer particles tied to a simulation's grid."""

    def __init__(self, sim_data, bc, n_particles, particle_generator="grid",
                 pos_array=None, init_array=None):
        self.sim_data = sim_data
        self.bc = bc

        # the compressible solver hands over its RuntimeParameters here
        if hasattr(n_particles, "get_param"):
            rp = n_particles
            n_particles = rp.get_param("particles.n_particles")
            particle_generator = rp.get_param("particles.particle_generator")

        if not callable(particle_generator) and \
                particle_generator != "array" and n_particles <= 0:
            msg.fail(f"ERROR: n_particles = {n_particles} <= 0")

        if callable(particle_generator):
            pos = np.asarray(particle_generator(n_particles), dtype=float)
            init = pos.copy()
        elif particle_generator == "random":
            pos, init = self._random_positions(n_particles)
        elif particle_generator == "grid":
            pos, init = self._grid_positions(n_particles)
        elif particle_generator == "array":
            if pos_array is None:
                msg.fail("ERROR: Array of particle positions has not been "
                         "passed into Particles constructor.")
            pos = np.asarray(pos_array, dtype=float)
            init = (np.asarray(init_array, dtype=float)
                    if init_array is not None else pos.copy())
        else:
            msg.fail("ERROR: do not recognise particle generator "
                     f"{particle_generator}")

        like = {"dtype": sim_data.dtype, "device": sim_data.device}
        self.positions = torch.as_tensor(pos, **like).reshape(-1, 2)
        self.init_positions = torch.as_tensor(init, **like).reshape(-1, 2)
        self.active = torch.ones(len(pos), dtype=torch.bool,
                                 device=sim_data.device)
        self.n_particles = len(pos)

    # -- generators ---------------------------------------------------------
    def _random_positions(self, n_particles):
        """Uniform positions from numpy's global generator, as the JAX
        package draws them, so one np.random.seed gives both the same."""
        myg = self.sim_data.grid
        pos = np.random.rand(n_particles, 2)
        pos[:, 0] = pos[:, 0] * (myg.xmax - myg.xmin) + myg.xmin
        pos[:, 1] = pos[:, 1] * (myg.ymax - myg.ymin) + myg.ymin
        return pos, pos.copy()

    def _grid_positions(self, n_particles):
        sq = int(round(np.sqrt(n_particles)))
        if sq ** 2 != n_particles:
            msg.warning(f"WARNING: Changing number of particles from "
                        f"{n_particles} to {sq ** 2}")
        myg = self.sim_data.grid
        xs, step = np.linspace(myg.xmin, myg.xmax, num=sq, endpoint=False,
                               retstep=True)
        xs = xs + 0.5 * step
        ys, step = np.linspace(myg.ymin, myg.ymax, num=sq, endpoint=False,
                               retstep=True)
        ys = ys + 0.5 * step
        xx, yy = np.meshgrid(xs, ys, indexing="ij")
        pos = np.stack([xx.ravel(), yy.ravel()], axis=1)
        return pos, pos.copy()

    # -- accessors ----------------------------------------------------------
    def get_positions(self):
        """(N_active, 2) numpy array of the current positions."""
        return self.positions[self.active].cpu().numpy()

    def get_init_positions(self):
        """(N_active, 2) numpy array of the initial positions."""
        return self.init_positions[self.active].cpu().numpy()

    # -- dynamics -----------------------------------------------------------
    def _interp(self, u_b, v_b, pos):
        """Bilinear velocity at the positions; u_b and v_b are the buf=1
        windows of the velocity fields."""
        myg = self.sim_data.grid
        xf = (pos[:, 0] - myg.xmin) / myg.dx - 0.5
        yf = (pos[:, 1] - myg.ymin) / myg.dy - 0.5
        x_frac = torch.remainder(xf, 1.0)
        y_frac = torch.remainder(yf, 1.0)
        # truncation (not floor) + 1, as the JAX package's int cast
        xi = (torch.trunc(xf).long() + 1).clamp(0, u_b.shape[0] - 2)
        yi = (torch.trunc(yf).long() + 1).clamp(0, u_b.shape[1] - 2)

        def bilin(f):
            return ((1 - x_frac) * (1 - y_frac) * f[xi, yi] +
                    x_frac * (1 - y_frac) * f[xi + 1, yi] +
                    (1 - x_frac) * y_frac * f[xi, yi + 1] +
                    x_frac * y_frac * f[xi + 1, yi + 1])

        return bilin(u_b), bilin(v_b)

    def advance_pure(self, pos, active, u, v, dt):
        """The midpoint (RK2) advance and the boundary enforcement:
        returns (new_pos, new_active) and leaves self as it is.  dt is a
        float or a 0-d tensor; nothing here reads the device."""
        myg = self.sim_data.grid
        u_b = ai(u, myg).v(buf=1)
        v_b = ai(v, myg).v(buf=1)
        return self.midpoint_advance(
            pos, active, lambda p: self._interp(u_b, v_b, p), dt)

    def midpoint_advance(self, pos, active, interp, dt):
        """advance_pure with the velocity at the positions given by
        interp(pos) -> (u, v): the sharded advance passes an owner-gathered
        interpolation (parallel/sharded_particles.py)."""
        u0, v0 = interp(pos)
        mid = pos + 0.5 * dt * torch.stack([u0, v0], dim=1)
        u1, v1 = interp(mid)
        new_pos = pos + dt * torch.stack([u1, v1], dim=1)

        pos = torch.where(active[:, None], new_pos, pos)
        return self._enforce_pure(pos, active)

    def update_particles(self, dt, u=None, v=None):
        """Midpoint (RK2) advance with the cell-centered velocity (the
        derived "velocity" of the simulation data where none is given)."""
        if (u is None) and (v is None):
            u, v = self.sim_data.get_var("velocity")
        elif u is None:
            u = self.sim_data.get_var("x-velocity")
        elif v is None:
            v = self.sim_data.get_var("y-velocity")

        self.positions, self.active = self.advance_pure(
            self.positions, self.active, u, v, dt)

    def enforce_particle_boundaries(self):
        """Apply the periodic wrap, reflection or outflow of each edge."""
        self.positions, self.active = self._enforce_pure(
            self.positions, self.active)

    def _enforce_pure(self, pos, active):
        if self.bc is None:
            return pos, active
        myg = self.sim_data.grid
        bc = self.bc

        def edge(c, active, lo, hi, lo_bc, hi_bc):
            below = c < lo
            if lo_bc in _OUT:
                active = active & ~below
            elif lo_bc == "periodic":
                c = torch.where(below, hi + c - lo, c)
            elif lo_bc in _REFLECT:
                c = torch.where(below, 2 * lo - c, c)
            else:
                msg.fail(f"ERROR: {lo_bc} invalid BC for particles")

            above = c > hi
            if hi_bc in _OUT:
                active = active & ~above
            elif hi_bc == "periodic":
                c = torch.where(above, lo + c - hi, c)
            elif hi_bc in _REFLECT:
                c = torch.where(above, 2 * hi - c, c)
            else:
                msg.fail(f"ERROR: {hi_bc} invalid BC for particles")
            return c, active

        x, active = edge(pos[:, 0], active, myg.xmin, myg.xmax,
                         bc.xlb, bc.xrb)
        y, active = edge(pos[:, 1], active, myg.ymin, myg.ymax,
                         bc.ylb, bc.yrb)
        return torch.stack([x, y], dim=1), active

    # -- I/O ----------------------------------------------------------------
    def write_particles(self, f):
        """Write the active particles' positions (float64) to an open
        HDF5 file (util/hdf5.py or h5py)."""
        gparticles = f.create_group("particles")
        gparticles.create_dataset(
            "particle_positions",
            data=np.asarray(self.get_positions(), dtype=np.float64))
        gparticles.create_dataset(
            "init_particle_positions",
            data=np.asarray(self.get_init_positions(), dtype=np.float64))
