"""The block mesh on torch.distributed, and the halo exchanges.

The port of pyro2_tpu/parallel/mesh_comm.py.  There one program runs on
every device of a `jax.sharding.Mesh` inside `shard_map`; here one rank
owns one block and runs the same code on it.  A `Mesh` holds the rank's
coordinates (ix, iy) on the px x py mesh (the JAX package's
`axis_index("x"/"y")`) and the axis subgroups, which every rank builds
with `dist.new_group`, in the same order.  The JAX primitives map as:

  * `ppermute` along an axis ring: `dist.batch_isend_irecv` inside that
    axis's subgroup (`Mesh.ppermute_pair`; `_ring_perm` / `_ring_perm_rev`
    name the partners);
  * a tiled `all_gather`: `all_gather_into_tensor` in the subgroup
    (`Mesh.all_gather`);
  * `psum` over x then y: `all_reduce` in each subgroup (`Mesh.psum`);
  * `pmin` / `pmax` over x then y: a MIN / MAX `all_reduce` in each
    subgroup (`Mesh.pmin`, `Mesh.pmax`), exact, so a sharded CFL dt is
    the serial global one.

An axis with one block does no communication, as the JAX functions skip
it.  `make_mesh()` without a process group returns a 1 x 1 mesh on the
default device (CUDA, or it raises, unless `device="cpu"`) and never
initialises torch.distributed: one card runs that way.  `parallel.launch`
starts the ranks of a larger mesh (gloo for CPU ranks, NCCL for CUDA ones).

Each rank's block is padded with ghost cells filled from the neighbouring
blocks; the blocks that own a domain edge then overwrite their ghosts with
the physical fill.  Every function returns a new tensor and leaves its
input as it was.

The exchange of an axis can be split: `Mesh.ppermute_start` posts the
pair's messages and `Pending.wait` takes them, so `halo_exchange_stack_start`
returns a `PendingFill` whose `finish()` completes the fill, and work
launched between the two overlaps the first split axis's messages
(parallel/overlap.py).  The blocking calls are the two halves back to back.

While `record_collectives()` is open, every collective a Mesh makes is
tallied under the JAX primitive it stands for, with its per-rank payload
bytes (parallel/accounting.py): a ppermute pair counts as two ppermutes,
an axis of one block counts nothing, and a collective made inside a
`dynamic_loop()` (the multigrid solve loop) marks the tally dynamic.
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from pyro2_tpu_torch.defaults import resolve_device
from pyro2_tpu_torch.mesh.indexer import _edge_fill

__all__ = ["Mesh", "Pending", "PendingFill", "factor_devices", "make_mesh",
           "halo_exchange", "halo_exchange_stack",
           "halo_exchange_stack_start", "gated_physical_fill",
           "seam_exchange", "seam_fill", "deep_pad_exchange",
           "deep_phys_refresh", "record_collectives", "dynamic_loop"]


# the open recorders, and how deep the calling code is in marked loops
_recorders = []
_loop_depth = [0]


class CollectiveRecord:
    """The tally of one `record_collectives()`: {primitive: {"count",
    "bytes"}} and whether a collective ran inside a `dynamic_loop()`."""

    def __init__(self):
        self.stats = {}
        self.dynamic = False


@contextlib.contextmanager
def record_collectives():
    """Tally every collective a Mesh makes while the context is open."""
    rec = CollectiveRecord()
    _recorders.append(rec)
    try:
        yield rec
    finally:
        _recorders.remove(rec)


@contextlib.contextmanager
def dynamic_loop():
    """Mark a loop whose trip count depends on the data: a collective made
    inside it marks the open recorders' tallies dynamic."""
    _loop_depth[0] += 1
    try:
        yield
    finally:
        _loop_depth[0] -= 1


def _record(primitive, count, *tensors):
    if not _recorders:
        return
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    for rec in _recorders:
        ent = rec.stats.setdefault(primitive, {"count": 0, "bytes": 0})
        ent["count"] += count
        ent["bytes"] += nbytes
        if _loop_depth[0]:
            rec.dynamic = True


class Pending:
    """A posted ppermute pair: `wait()` returns (from_left, from_right)."""

    def __init__(self, works, from_left, from_right, sent):
        self._works = works
        self._out = (from_left, from_right)
        self._sent = sent            # the sources stay alive until the wait

    def wait(self):
        for work in self._works:
            work.wait()
        self._works, self._sent = (), ()
        return self._out


def factor_devices(n):
    """Split n devices into the most-square (px, py) factorization."""
    px = int(np.sqrt(n))
    while n % px != 0:
        px -= 1
    return px, n // px


def _ring_perm(n):
    """Forward ring permutation [(0,1), (1,2), ..., (n-1,0)]."""
    return [(i, (i + 1) % n) for i in range(n)]


def _ring_perm_rev(n):
    return [(i, (i - 1) % n) for i in range(n)]


class Mesh:
    """A px x py mesh of ranks seen from one of them: its block's
    coordinates, its device and the axis subgroups.  Rank r holds block
    (r // py, r % py), the layout of the JAX package's device grid."""

    def __init__(self, shape, device, coords=(0, 0), groups=None):
        self.px, self.py = (int(s) for s in shape)
        self.shape = (self.px, self.py)
        self.device = torch.device(device)
        self.ix, self.iy = (int(c) for c in coords)
        # axis -> (subgroup, global ranks along the axis in coordinate order)
        self._groups = groups or {}

    @property
    def owned_edges(self):
        """(xl, xr, yl, yr): whether this rank's block owns each domain
        edge (both edges of an axis: the axis is not split)."""
        return (self.ix == 0, self.ix == self.px - 1, self.iy == 0,
                self.iy == self.py - 1)

    def size(self, axis):
        return self.px if axis == "x" else self.py

    def index(self, axis):
        return self.ix if axis == "x" else self.iy

    def ppermute_pair(self, axis, hi_src, lo_src):
        """(from_left, from_right): the left neighbour's hi_src and the right
        neighbour's lo_src around the axis ring -- the JAX package's
        ppermute over `_ring_perm` and over `_ring_perm_rev`."""
        return self.ppermute_start(axis, hi_src, lo_src).wait()

    def ppermute_start(self, axis, hi_src, lo_src):
        """Post ppermute_pair's messages; the returned Pending's `wait()`
        gives its result."""
        n, idx = self.size(axis), self.index(axis)
        group, ring = self._groups[axis]
        right = ring[_ring_perm(n)[idx][1]]
        left = ring[_ring_perm_rev(n)[idx][1]]
        hi_src, lo_src = hi_src.contiguous(), lo_src.contiguous()
        _record("ppermute", 2, hi_src, lo_src)
        from_left = torch.empty_like(hi_src)
        from_right = torch.empty_like(lo_src)
        # the tags keep the two messages apart when left == right (n == 2)
        ops = [dist.P2POp(dist.isend, hi_src, right, group, tag=0),
               dist.P2POp(dist.irecv, from_left, left, group, tag=0),
               dist.P2POp(dist.isend, lo_src, left, group, tag=1),
               dist.P2POp(dist.irecv, from_right, right, group, tag=1)]
        return Pending(dist.batch_isend_irecv(ops), from_left, from_right,
                       (hi_src, lo_src))

    def all_gather(self, axis, t, dim):
        """The blocks of the axis concatenated along `dim` in coordinate
        order (a tiled all_gather)."""
        n = self.size(axis)
        if n == 1:
            return t
        t = t.contiguous()
        _record("all_gather", 1, t)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self._groups[axis][0])
        return torch.cat(parts, dim)

    def psum(self, t):
        """The sum of t over every block: over x, then over y."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmin(self, t):
        """The minimum of t over every block: over x, then over y."""
        return self._reduce(t, dist.ReduceOp.MIN)

    def pmax(self, t):
        """The maximum of t over every block: over x, then over y."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def _reduce(self, t, op):
        t = t.clone()
        for axis in ("x", "y"):
            if self.size(axis) > 1:
                _record(_REDUCE_NAMES[op], 1, t)
                dist.all_reduce(t, op=op, group=self._groups[axis][0])
        return t


_REDUCE_NAMES = {dist.ReduceOp.SUM: "psum", dist.ReduceOp.MIN: "pmin",
                 dist.ReduceOp.MAX: "pmax"}


def make_mesh(n_devices=None, shape=None, *, device=None):
    """The ("x", "y") mesh of this rank.

    Without a process group: a 1 x 1 mesh on `device` (CUDA by default).
    With one: (px, py) = `shape`, or the most square factorization of the
    world size; a CUDA rank takes card rank % device_count.  Every rank must
    call it, since it creates the axis subgroups."""
    if not dist.is_available() or not dist.is_initialized():
        if shape not in (None, (1, 1)) or n_devices not in (None, 1):
            raise ValueError("a mesh of more than one block needs a process "
                             "group (see pyro2_tpu_torch.parallel.launch)")
        return Mesh((1, 1), resolve_device(device))
    world, rank = dist.get_world_size(), dist.get_rank()
    if shape is None:
        shape = factor_devices(n_devices if n_devices is not None else world)
    px, py = shape
    if px * py != world:
        raise ValueError(f"a {px} x {py} mesh needs {px * py} ranks, the "
                         f"process group has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    groups = {}
    # every rank creates every subgroup, in the same order
    if px > 1:
        for j in range(py):
            ring = [i * py + j for i in range(px)]
            g = dist.new_group(ring)
            if j == rank % py:
                groups["x"] = (g, ring)
    if py > 1:
        for i in range(px):
            ring = [i * py + j for j in range(py)]
            g = dist.new_group(ring)
            if i == rank // py:
                groups["y"] = (g, ring)
    return Mesh(shape, dev, divmod(rank, py), groups)


def _exchange_start(a, mesh, axis, depth):
    """Post the exchange of one axis's depth-deep halos (None on an axis of
    one block): (dim, depth, Pending)."""
    if mesh.size(axis) == 1:
        return None
    dim = a.ndim - 2 if axis == "x" else a.ndim - 1
    hi_src = a.narrow(dim, a.shape[dim] - 2 * depth, depth)
    lo_src = a.narrow(dim, depth, depth)
    return dim, depth, mesh.ppermute_start(axis, hi_src, lo_src)


def _exchange_finish(a, posted):
    """Copy a posted exchange's strips into a's halos (in place)."""
    dim, depth, pending = posted
    from_left, from_right = pending.wait()
    a.narrow(dim, 0, depth).copy_(from_left)
    a.narrow(dim, a.shape[dim] - depth, depth).copy_(from_right)


def _exchange(a, mesh, axis, depth):
    """Fill the depth-deep halos of one axis with the ring neighbours'
    adjacent interior strips (in place)."""
    posted = _exchange_start(a, mesh, axis, depth)
    if posted is not None:
        _exchange_finish(a, posted)
    return a


def _physical(a, g, bc, mesh, axis):
    """The physical fills of one axis's domain edges, in place, on the
    blocks that own them.  Periodic ghosts come from the ring, except on an
    unsplit axis, where the exchange is a no-op and the local periodic
    copy applies.  Extended BC kinds (bnd.ext_bcs) are left alone here:
    _edge_fill fills none of them."""
    if axis == "x":
        edges = ((0, bc.xlb, bc.xl_value, mesh.ix == 0),
                 (1, bc.xrb, bc.xr_value, mesh.ix == mesh.px - 1))
        dim, n, dxy = -2, mesh.px, g.dx
    else:
        edges = ((0, bc.ylb, bc.yl_value, mesh.iy == 0),
                 (1, bc.yrb, bc.yr_value, mesh.iy == mesh.py - 1))
        dim, n, dxy = -1, mesh.py, g.dy
    for side, kind, value, own in edges:
        if (kind != "periodic" or n == 1) and own:
            _edge_fill(a, g, dim, side, kind, value, dxy)


def halo_exchange(padded, local_grid, bc, mesh):
    """Fill the ghost cells of a local padded (..., qx, qy) block.

    Interior block edges receive the neighbour's adjacent interior strip
    (a periodic ring, which IS the physical fill for periodic global BCs);
    for non-periodic BCs the blocks owning a domain edge overwrite their
    ghosts with the physical fill.  x strips go before y, so corner ghosts
    take the single-block fill's x-then-y order."""
    a = padded.clone()
    return _fill(a, local_grid, [(a, bc)], mesh)


def halo_exchange_stack(padded, local_grid, bcs, mesh):
    """halo_exchange of an (nvar, qx, qy) stack whose variable n has its
    own BC, bcs[n]: one exchange of the whole stack a side, then each
    variable's physical fills, which gives halo_exchange's values variable
    by variable in 2 messages a split axis instead of 2 nvar."""
    return halo_exchange_stack_start(padded, local_grid, bcs, mesh).finish()


class PendingFill:
    """A halo fill whose first split axis's messages are posted; `finish()`
    waits for them and completes the fill (the same values as the blocking
    fill), returning the filled copy."""

    def __init__(self, steps, a):
        self._steps = steps
        self._a = a

    def finish(self):
        for _ in self._steps:
            pass
        return self._a


def halo_exchange_stack_start(padded, local_grid, bcs, mesh):
    """halo_exchange_stack up to its first message: the fills that need no
    message run, the first split axis's strips are posted, and the
    returned PendingFill completes the rest."""
    a = padded.clone()
    steps = _fill_steps(a, local_grid, list(zip(a, bcs, strict=True)), mesh)
    next(steps, None)
    return PendingFill(steps, a)


def _fill(a, g, planes, mesh):
    """The exchange of a (in place), x then y, each axis followed by the
    physical fills of each (plane of a, BC) pair."""
    for _ in _fill_steps(a, g, planes, mesh):
        pass
    return a


def _fill_steps(a, g, planes, mesh):
    """_fill as a generator that stops once after posting each split axis's
    messages (the x strips go before y, so corner ghosts take the
    single-block fill's x-then-y order)."""
    for axis in ("x", "y"):
        posted = _exchange_start(a, mesh, axis, g.ng)
        if posted is not None:
            yield
            _exchange_finish(a, posted)
        for plane, bc in planes:
            _physical(plane, g, bc, mesh, axis)


def gated_physical_fill(a, local_grid, bc, owns):
    """Physical-BC ghost fill on the edges in `owns` (xl, xr, yl, yr; a
    Mesh's owned_edges, or an overlap band's), with NO halo exchange: for
    fields whose seam ghosts already hold their pointwise values.
    Periodic ghosts are likewise left, except on an axis whose two edges
    are both owned (not split), where the local copy applies."""
    g = local_grid
    a = a.clone()
    for edge, axis, side, own, unsplit in (
            ("xlb", -2, 0, owns[0], owns[0] and owns[1]),
            ("xrb", -2, 1, owns[1], owns[0] and owns[1]),
            ("ylb", -1, 0, owns[2], owns[2] and owns[3]),
            ("yrb", -1, 1, owns[3], owns[2] and owns[3])):
        btype = getattr(bc, edge)
        dxy = g.dx if axis == -2 else g.dy
        if btype == "periodic":
            if unsplit:
                _edge_fill(a, g, axis, side, btype, None, dxy)
            continue
        if own:
            _edge_fill(a, g, axis, side, btype,
                       getattr(bc, edge[:2] + "_value"), dxy)
    return a


# ---------------------------------------------------------------------------
# deep-halo exchange (communication-avoiding smoothing)
#
# Exchange ONE d-deep halo and recompute the halo cells locally: each half
# sweep shrinks the valid halo band by one cell, so d cells of halo buy
# (d-1)//2 red-black sweeps with no further communication, and every updated
# cell computes the same arithmetic on the same operands as the
# exchange-per-half-sweep schedule.
# ---------------------------------------------------------------------------

def deep_phys_refresh(a, bc, mesh, dpx, dpy):
    """The depth-1 physical-BC ghost refresh of a deep-padded (...,
    bx+2*dpx, by+2*dpy) frame.

    Seam sides (a split axis) are untouched except on the domain-edge
    blocks of a non-periodic axis; an UNSPLIT periodic axis gets the local
    wrap copy (its pad depth is 1).  Homogeneous standard BC kinds only.
    The order x-lo, x-hi, y-lo, y-hi over full rows is fill_ghost's, so
    corner ghosts agree."""
    a = a.clone()
    bx, by = a.shape[-2] - 2 * dpx, a.shape[-1] - 2 * dpy

    def one_edge(dim, dp, b, kind, side):
        ghost = dp - 1 if side == 0 else dp + b
        if kind == "periodic":
            src = ghost + b if side == 0 else ghost - b
        else:
            src = ghost + 1 if side == 0 else ghost - 1
        row = a.select(dim, src)
        a.select(dim, ghost).copy_(-row if kind in ("dirichlet",
                                                    "reflect-odd") else row)

    for dim, p, idx, dp, b, lo, hi in (
            (a.ndim - 2, mesh.px, mesh.ix, dpx, bx, bc.xlb, bc.xrb),
            (a.ndim - 1, mesh.py, mesh.iy, dpy, by, bc.ylb, bc.yrb)):
        if lo == "periodic":
            if p == 1:
                one_edge(dim, dp, b, "periodic", 0)
                one_edge(dim, dp, b, "periodic", 1)
        else:
            if idx == 0:
                one_edge(dim, dp, b, lo, 0)
            if idx == p - 1:
                one_edge(dim, dp, b, hi, 1)
    return a


def deep_pad_exchange(interior, bc, mesh, dpx, dpy, *, phys=True):
    """(..., bx, by) local interior block -> (..., bx+2*dpx, by+2*dpy)
    deep-padded frame: split-axis halos carry the neighbour's adjacent
    dpx / dpy interior strips (2 messages per split axis, whatever the
    depth), unsplit axes zeros, and (when `phys`) the domain-edge blocks
    and unsplit periodic axes the depth-1 physical fill of
    `deep_phys_refresh`.

    On a non-periodic split axis the edge blocks' outer halo rows beyond
    depth 1 keep the ring's wrapped payload: callers never read them (the
    deep-smoothing masks guarantee it), and they hold what the JAX
    package's exchange leaves there."""
    a = F.pad(interior, (dpy, dpy, dpx, dpx))
    a = _exchange(a, mesh, "x", dpx)
    a = _exchange(a, mesh, "y", dpy)
    if phys:
        a = deep_phys_refresh(a, bc, mesh, dpx, dpy)
    return a


def seam_fill(a, bc, mesh):
    """The one-ghost halos of a padded (..., bx+2, by+2) block across its
    seams, and nothing else: each side with a neighbouring block (around
    the ring on a periodic axis) takes that block's adjacent interior
    strip, x before y (so a corner takes the x-filled strip of its y
    neighbour), and a domain edge of a non-periodic axis keeps the ghosts
    it has.  The sharded multigrid's half-sweep kernel fills the physical
    ghosts itself; this fills the rest.  Returns a new tensor, or `a`
    itself when no axis is split."""
    if mesh.px == 1 and mesh.py == 1:
        return a
    a = a.clone()
    for axis, periodic in (("x", bc.xlb == "periodic"),
                           ("y", bc.ylb == "periodic")):
        posted = _exchange_start(a, mesh, axis, 1)
        if posted is None:
            continue
        dim, depth, pending = posted
        from_left, from_right = pending.wait()
        n, idx = mesh.size(axis), mesh.index(axis)
        if periodic or idx != 0:
            a.narrow(dim, 0, 1).copy_(from_left)
        if periodic or idx != n - 1:
            a.narrow(dim, a.shape[dim] - 1, 1).copy_(from_right)
    return a


def seam_exchange(a, local_grid, mesh):
    """Exchange of interior-adjacent strips across block seams ONLY: the
    domain-edge blocks keep their local ghost values on the domain side.
    For face-centred intermediates (MAC velocities) whose global ghosts are
    never BC-filled."""
    ng = local_grid.ng
    a = a.clone()
    for axis in ("x", "y"):
        n = mesh.size(axis)
        if n == 1:
            continue
        dim = a.ndim - 2 if axis == "x" else a.ndim - 1
        hi_src = a.narrow(dim, a.shape[dim] - 2 * ng, ng)
        lo_src = a.narrow(dim, ng, ng)
        from_left, from_right = mesh.ppermute_pair(axis, hi_src, lo_src)
        idx = mesh.index(axis)
        if idx != 0:
            a.narrow(dim, 0, ng).copy_(from_left)
        if idx != n - 1:
            a.narrow(dim, a.shape[dim] - ng, ng).copy_(from_right)
    return a
