"""Tracer particles over a mesh of ranks.

The port of pyro2_tpu/parallel/sharded_particles.py.  Particle positions
are global data of O(n_particles), so every rank holds all of them (they
stay replicated); only the velocity interpolation needs the partitioned
grid.  Each particle's bilinear stencil (its base cell and one neighbour
on each axis) lies inside the padded frame of exactly one block, the one
that owns the base cell, whose one-cell halo covers the stencils that
straddle a seam.  So:

  * each rank evaluates the serial bilinear formula (Particles._interp)
    for the particles it owns, on its padded velocity block;
  * `Mesh.psum` replicates the velocities: each particle has one nonzero
    contribution, its owner's, and adding zeros is exact;
  * the midpoint (RK2) advance and the edge enforcement run on every rank
    alike, through the serial `Particles.midpoint_advance`.

The owner's stencil cells hold the serial global window's values (a halo
cell is the neighbour's interior value, a domain ghost the same physical
fill), and the arithmetic is the serial expression, so the sharded advance
equals the serial one bit for bit.  Plain tensor code: the JAX package
computes this outside any Pallas kernel.
"""

import torch

__all__ = ["make_sharded_particle_advance"]


def make_sharded_particle_advance(particles, local_grid, mesh):
    """advance(pos, active, u_blk, v_blk, dt) -> (pos, active) on this rank
    of `mesh` (collective: every rank calls it with the same positions).

    particles: a serial, global-grid Particles supplying the geometry, the
    BCs and the edge enforcement.  u_blk, v_blk: this rank's padded (bx +
    2 ng, by + 2 ng) velocity blocks with their halos and ghosts filled (a
    one-cell ring is enough; a deeper one is indexed past)."""
    gg = particles.sim_data.grid
    bx, by, ng = local_grid.nx, local_grid.ny, local_grid.ng
    px, py, ix, iy = mesh.px, mesh.py, mesh.ix, mesh.iy

    def interp(u_blk, v_blk, pos):
        # Particles._interp's index and fraction arithmetic
        xf = (pos[:, 0] - gg.xmin) / gg.dx - 0.5
        yf = (pos[:, 1] - gg.ymin) / gg.dy - 0.5
        x_frac = torch.remainder(xf, 1.0)
        y_frac = torch.remainder(yf, 1.0)
        # the serial window index, clamped to [0, nx] / [0, ny]
        xi = (torch.trunc(xf).long() + 1).clamp(0, gg.nx)
        yi = (torch.trunc(yf).long() + 1).clamp(0, gg.ny)
        own = (((xi // bx).clamp(0, px - 1) == ix) &
               ((yi // by).clamp(0, py - 1) == iy))
        # the window cell in the padded block (the clamp keeps the gathers
        # of particles owned elsewhere in bounds; they are masked out)
        lxi = (xi - ix * bx).clamp(0, bx + 1) + (ng - 1)
        lyi = (yi - iy * by).clamp(0, by + 1) + (ng - 1)

        def bilin(f):
            val = ((1 - x_frac) * (1 - y_frac) * f[lxi, lyi] +
                   x_frac * (1 - y_frac) * f[lxi + 1, lyi] +
                   (1 - x_frac) * y_frac * f[lxi, lyi + 1] +
                   x_frac * y_frac * f[lxi + 1, lyi + 1])
            return torch.where(own, val, torch.zeros_like(val))

        # one reduction for both components
        uv = mesh.psum(torch.stack([bilin(u_blk), bilin(v_blk)]))
        return uv[0], uv[1]

    def advance(pos, active, u_blk, v_blk, dt):
        return particles.midpoint_advance(
            pos, active, lambda p: interp(u_blk, v_blk, p), dt)

    return advance
