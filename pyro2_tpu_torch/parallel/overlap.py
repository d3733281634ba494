"""The overlapped sharded step, and the halo accounting of a step.

The port of pyro2_tpu/parallel/overlap.py.  The plain sharded step
(parallel/sharded.py) fills the halos, then steps: every output cell
waits for the exchange.  The overlapped step splits it:

* the CORE, the interior cells at least ng from every block edge, comes
  from the block step on the UNFILLED padded block (zero ghosts), launched
  while the first split axis's halo messages are in flight
  (`mesh_comm.halo_exchange_stack_start`);
* the ng-deep RIM comes from four band steps on 4 ng-wide slices of the
  filled block (the seam density floor applied, as the plain step's
  input), each band keeping the ng rows or columns of the rim.

A core cell's stencil reaches ng cells, so it never reads a ghost: the
zero-density ghosts make NaN or inf only in the rim's outputs, which the
bands overwrite.  Each band's outer side keeps the block's solid and
domain-edge flags and gated source fill, its inner side is interior (a
seam); the flags are fixed for a rank, so the four band steps are built
once, at construction: `CTUStep` or `SWEStep` (`k_ctu`, `k_swe` on CUDA,
rows 1 and 5 of PERF.md section 6) of band-shaped block-local Simulations
sharing the block's runtime parameters, on window grids with the global dx
and dy and the band's global coordinates (blocks.adopt_window_grid).  A
step launches 5 block steps (1 core + 4 bands) where the plain one
launches 1, and recomputes ~4 ng (bx + by) / (bx by) of the zone updates
(6% for 512^2 blocks); it equals the plain step bit for bit (the kernel and
the plain step compute each cell with the same arithmetic on the same
operands whatever the frame).

With NCCL the exchange runs on its own stream and the core on the compute
stream; with gloo the messages move while the host enqueues the core.  On
a 1 x 1 mesh nothing is exchanged and the overlap only costs the bands.

`ShardedCompressible` and `ShardedSWE` take it (`overlap=True`); the MOL
classes take none, as in JAX.  Refused with a ValueError, as in JAX:
blocks narrower than 4 ng, extended BCs and spherical geometry.
"""

import torch.nn.functional as F

from pyro2_tpu_torch.parallel.blocks import adopt_window_grid
from pyro2_tpu_torch.parallel.mesh_comm import halo_exchange_stack_start
from pyro2_tpu_torch.util.runparams import RuntimeParameters

__all__ = ["OverlappedStep", "build_overlapped_step", "halo_stats"]


def _band_step(ss, shape, shift, keep):
    """The step of a band-shaped block-local Simulation sharing ss's
    runtime parameters: `shape` interior cells, its first at block cell
    `shift`, the block's flags on the sides it keeps (`keep`: xl, xr, yl,
    yr); a side it does not keep is a seam."""
    g = ss.local_grid
    rp = RuntimeParameters()
    rp.params = dict(ss.local_sim.rp.params)
    rp.param_comments = dict(ss.local_sim.rp.param_comments)
    for axis, n, b in (("x", shape[0], g.nx), ("y", shape[1], g.ny)):
        lo = rp.get_param(f"mesh.{axis}min")
        hi = rp.get_param(f"mesh.{axis}max")
        rp.set_param(f"mesh.n{axis}", n)
        rp.set_param(f"mesh.{axis}max", lo + (hi - lo) * n / b)
    sim = type(ss.local_sim)(ss.solver, ss.problem, lambda d, r: None, rp,
                             device=ss.mesh.device, dtype=ss.dtype)
    sim.initialize(ng=ss.ng)
    adopt_window_grid(sim.cc_data.grid, ss.rp,
                      (ss.mesh.ix * g.nx + shift[0],
                       ss.mesh.iy * g.ny + shift[1]))
    owns = tuple(bool(o and k) for o, k in zip(ss.mesh.owned_edges, keep))
    return ss.local_step(sim, owns)


class OverlappedStep:
    """step(U_int, t, dt) of a ShardedSim, overlapped (see the module
    docstring).  `core(U_pad, t, dt)` is the core pass on an unfilled
    padded block and `rim(out, U_fill, t, dt)` writes the bands' rims of
    a filled one into it; `bands` are the four band steps (x-lo, x-hi,
    y-lo, y-hi)."""

    def __init__(self, ss):
        g = ss.local_grid
        ng = ss.ng
        bx, by = g.nx, g.ny
        if bx < 4 * ng or by < 4 * ng:
            raise ValueError(
                f"overlapped stepping needs block dims >= {4 * ng} "
                f"(got {bx}x{by}); use the plain sharded step")
        if ss._has_ext:
            raise ValueError("extended BCs are not supported by the "
                             "overlapped step variant yet; use "
                             "overlap=False")
        if ss._spherical:
            raise ValueError("the overlapped step does not take spherical "
                             "geometry; use overlap=False")
        self.ss = ss
        w, all_ = 4 * ng, slice(None)
        # (slice of the filled block, band step, block rim <- band cells)
        self._bands = [
            ((all_, slice(0, w), all_),
             _band_step(ss, (2 * ng, by), (0, 0), (1, 0, 1, 1)),
             (all_, slice(0, ng), all_),
             (all_, slice(ng, 2 * ng), slice(ng, -ng))),
            ((all_, slice(bx + 2 * ng - w, None), all_),
             _band_step(ss, (2 * ng, by), (bx - 2 * ng, 0), (0, 1, 1, 1)),
             (all_, slice(bx - ng, bx), all_),
             (all_, slice(2 * ng, 3 * ng), slice(ng, -ng))),
            ((all_, all_, slice(0, w)),
             _band_step(ss, (bx, 2 * ng), (0, 0), (1, 1, 1, 0)),
             (all_, all_, slice(0, ng)),
             (all_, slice(ng, -ng), slice(ng, 2 * ng))),
            ((all_, all_, slice(by + 2 * ng - w, None)),
             _band_step(ss, (bx, 2 * ng), (0, by - 2 * ng), (1, 1, 0, 1)),
             (all_, all_, slice(by - ng, by)),
             (all_, slice(ng, -ng), slice(2 * ng, 3 * ng))),
        ]
        self.bands = [b[1] for b in self._bands]

    def core(self, U_pad, t, dt):
        """The block step's interior on an unfilled padded block: right at
        the core cells."""
        return self.ss._interior(self.ss._block_step(U_pad, t, dt))

    def rim(self, out, U_fill, t, dt):
        """`out` with its ng-deep rim from the band steps on the filled
        padded block (the plain step's input)."""
        for src, band, rim, cells in self._bands:
            out[rim] = band(U_fill[src].contiguous(), t, dt)[cells]
        return out

    def __call__(self, U_int, t, dt):
        ss = self.ss
        ng = ss.ng
        U_pad = F.pad(U_int, (ng, ng, ng, ng))
        fill = halo_exchange_stack_start(U_pad, ss.local_grid, ss.bcs,
                                         ss.mesh)
        # the core: no collective in its inputs
        out = self.core(U_pad, t, dt)
        return self.rim(out, ss._floor_seams(fill.finish()), t, dt)


def build_overlapped_step(ss):
    """An overlapped step(U_int, t, dt) for a ShardedCompressible or
    ShardedSWE: the same signature and bit-for-bit the same results as the
    plain ss.step.  Needs blocks of at least 4 ng cells a side, so that a
    band's inner side lies inside the block."""
    return OverlappedStep(ss)


def halo_stats(ss):
    """Per-step halo accounting of a ShardedSim (one halo fill a step),
    computed from the block geometry (no run): the bytes this rank sends,
    its ppermutes, the core fraction (the share of output zones with no
    collective in their inputs: the overlap's window) and the rim
    recompute the overlap costs.

    The keys are JAX's; `ppermutes_per_step` counts the port's stacked
    fill, 2 per split axis, where JAX counts 2 nvar; the bytes are the
    same; `itemsize` is that of ss.dtype."""
    g = ss.local_grid
    ng, bx, by = g.ng, g.nx, g.ny
    itemsize = ss.local_sim.cc_data.data.element_size()
    # each split axis: 2 messages, each an (nvar, ng, qy) / (nvar, qx, ng)
    # strip
    ex_x = 2 if ss.px > 1 else 0
    ex_y = 2 if ss.py > 1 else 0
    strips_bytes = ss.nvar * (ex_x * ng * g.qy + ex_y * ng * g.qx) * itemsize
    core = max(bx - 2 * ng, 0) * max(by - 2 * ng, 0) / (bx * by)
    rim_extra = (4 * ng * (bx + by)) / (bx * by)
    return {
        "block": [bx, by],
        "mesh": [ss.px, ss.py],
        "halo_bytes_per_step": strips_bytes,
        "ppermutes_per_step": ex_x + ex_y,
        "core_fraction": core,
        "rim_recompute_fraction": rim_extra,
    }
