"""Block-partitioned multigrid over a mesh of ranks.

The port of pyro2_tpu/parallel/sharded_mg.py.  Each rank runs this object
on its own block of the global nx x ny interior (rank r owns block
(r // py, r % py) of a px x py mesh, see parallel.mesh_comm); where the
JAX package ran one `shard_map` program, every rank here runs the same
Python, and the mesh's collectives replace ppermute, all_gather and psum.

* Every level whose per-block size is large enough stays block-
  partitioned.  The default smoothing schedule is COMMUNICATION-AVOIDING
  (`comm_mode="deep"`): one d-deep halo exchange per smoothing round buys
  (d-1)//2 red-black sweeps computed redundantly on the halo band, and
  every updated cell evaluates the same arithmetic on the same operands as
  the exchange-per-half-sweep schedule (`comm_mode="sweep"`, kept for
  cross-checking), so the two agree bit for bit.
* `smoother="rbgs"` (default) is the reference-parity red-black
  Gauss-Seidel; `"jacobi"` (damped, omega 0.8) and `"chebyshev"` read only
  the old iterate and need one halo cell per step.
* Below the crossover the residual blocks are gathered into a replicated
  global coarse problem, solved identically on every rank by the serial
  V-cycle, and each rank slices its own block of the correction back out.
* The operator math is not duplicated: a smoothing round is one
  `multigrid.sharded_mg_kernel.deep_smooth`; the exchange-per-half-sweep
  schedule is `sharded_mg_kernel.sweep` (one colour pass of the serial
  `_smooth_once` between fills of the physical ghosts, or the serial
  `_residual` and `restrict_array`) with a seam exchange between calls;
  the replicated coarse cycle is the serial multigrid's
  (`mg_kernel.coarse_cycle`).

Two structures, chosen by `use_pallas` (the JAX package's keyword; None
picks the kernel structure on a CUDA mesh with comm_mode "deep", else the
plain one),
each a kernel a numerical step on a CUDA mesh and its plain version on the
CPU (`structure` says which entries a cycle launches, from the sizes
alone):

* the kernel structure (`use_pallas=True`): each smoothing round is one
  `mg_deep_smooth` (the last pre-smoothing round also restricts the
  residual, the last round of the finest level also returns it), each
  correction one `mg_correct`, and the replicated coarse solve one core
  kernel of the serial multigrid (`mg_kernel.core`), which holds every
  level up to `mg_kernel.CORE_MAX[dtype]` on a 1 x 1 mesh and 64^2
  otherwise.  On a 1 x 1 mesh at 1024^2 in float32 the levels 256^2,
  512^2 and 1024^2 are sharded, so a cycle launches 3 x 3 + 1 kernels.
  A sharded level too thin for a deep round smooths as the plain
  structure's sweep levels do;
* the plain structure (`use_pallas=False`, or `comm_mode="sweep"`): the
  JAX package's jnp cycle with the plain crossover: deep rounds
  (`mg_deep_smooth`, frame only) or, with `comm_mode="sweep"` and on
  levels too thin for a round, `mg_sweep` a colour pass with the seam
  exchange between; the residual and its restriction one `mg_sweep`, the
  correction one `mg_correct`, and the replicated coarse cycle the serial
  kernels' (`mg_kernel.coarse_cycle`: the core, and a down and an up for
  each level above CORE_MAX).

There is no fallback from one structure to the other, nor from a kernel
to its plain version.

Supported BCs: the standard homogeneous kinds (dirichlet / neumann /
outflow / reflect-* / periodic); anything else raises.  The global
reductions (the source norm, the residual norm, the relative change) are
summed over every rank.
"""

import math
import types

import torch
import torch.nn.functional as F

from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.multigrid import mg_kernel, sharded_mg_kernel
from pyro2_tpu_torch.multigrid.general_MG import GeneralMG2d
from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d
from pyro2_tpu_torch.multigrid.variable_coeff_MG import VarCoeffCCMG2d
from pyro2_tpu_torch.parallel.mesh_comm import (deep_pad_exchange,
                                                dynamic_loop, halo_exchange,
                                                seam_fill)
from pyro2_tpu_torch.util import msg

__all__ = ["ShardedMG", "ShardedVarCoeffMG", "ShardedGeneralMG",
           "kernel_flags", "make_sharded_mg", "stats", "structure"]

_SUPPORTED_BCS = frozenset(
    ["outflow", "neumann", "dirichlet", "reflect-odd", "reflect-even",
     "periodic"])

# solves (solve_local calls, `solve`'s and the solver tiers' inline ones)
# and V-cycles run since the counts were last reset (read by chip_smoke.py
# beside the kernels' launch counts)
stats = {"solves": 0, "cycles": 0}

# deep mode prefers replicating levels whose split-axis blocks are smaller
# than this (one exchange then buys >= 7 sweeps)
DEEP_CROSSOVER = 16


def _check_bcs(*bc_types):
    for t in bc_types:
        if t not in _SUPPORTED_BCS:
            raise ValueError(
                f"BC '{t}' is not supported by the sharded MG path")


def structure(nx, ny, px, py, *, dtype, op="const", comm_mode="deep",
              smoother="rbgs", use_pallas=None, cuda=True, nsmooth=10,
              nsmooth_bottom=50, nsmooth_speed=None):
    """The structure of a sharded solve of an nx x ny grid (a power of 2,
    square) on a px x py mesh, from the sizes alone (nothing is
    allocated): a namespace of `use_pallas` (None: the kernel structure
    when `cuda` and comm_mode is "deep", else the plain one),
    `nsmooth_speed`, `k_cross` (the coarsest sharded level), `deep_geom`
    ({sharded level: its deep-halo geometry, or None where the level
    smooths by sweeps}), `entries` ({level: {kernel entry: launches} of
    one V-cycle's visit; the replicated coarse level under k_cross - 1})
    and `launches` (their sum a cycle).  The entries are the kernels a
    CUDA mesh launches; the CPU runs their plain versions in the same
    places.  `op` ("const", "vc", "general") names the coarse entries."""
    if comm_mode not in ("deep", "sweep"):
        raise ValueError(f"unknown comm_mode '{comm_mode}'")
    if smoother not in sharded_mg_kernel.SMOOTHERS:
        raise ValueError(f"unknown smoother '{smoother}'")
    if smoother != "rbgs" and comm_mode != "deep":
        raise ValueError("speed smoothers require comm_mode='deep'")
    if use_pallas is None:
        # comm_mode "sweep" is the plain structure's schedule
        use_pallas = cuda and comm_mode == "deep"
    if use_pallas and comm_mode != "deep":
        raise ValueError("use_pallas requires comm_mode='deep'")
    if nx % px != 0 or ny % py != 0:
        raise ValueError("grid must divide evenly over the mesh")
    # Chebyshev of degree ~4 matches 10 RB-GS sweeps' smoothing power;
    # damped Jacobi needs a few more
    if nsmooth_speed is None:
        nsmooth_speed = 4 if smoother == "chebyshev" else 8
    nlevels = int(math.log(nx) / math.log(2.0))     # as CellCenterMG2d's
    sizes = [2 ** (k + 1) for k in range(nlevels)]   # cells a side

    # crossover: the coarsest block-partitioned level.  Blocks stay even
    # powers of 2 above it, so local red-black parity == global parity and
    # the local factor-2 restriction is exact.  Deep mode prefers
    # split-axis blocks >= DEEP_CROSSOVER cells (one exchange buys >= 7
    # sweeps): tiny sharded levels cost more in halo latency than
    # replicated compute
    def coarsest(min_seam_block):
        for k, n in enumerate(sizes):
            if n % px != 0 or n % py != 0:
                continue
            bx, by = n // px, n // py
            if bx < 2 or by < 2:
                continue
            seam = ([bx] if px > 1 else []) + ([by] if py > 1 else [])
            if not seam or min(seam) >= min_seam_block:
                return k
        return None

    if comm_mode == "deep":
        k_cross = coarsest(DEEP_CROSSOVER)
        if k_cross is None:
            k_cross = coarsest(4)
    else:
        k_cross = coarsest(2)
    if k_cross is None:
        k_cross = coarsest(2)
    if k_cross is None:
        raise ValueError(
            f"no level of a {nx}x{ny} grid gives >=2x2 blocks on a "
            f"{px}x{py} mesh -- use the serial solver")
    if use_pallas:
        # one core kernel solves the gathered coarse problem: replicate
        # every level it holds (on a 1x1 mesh the cycle is then the serial
        # one's shape), 64^2 when blocks exchange halos
        repl_max = mg_kernel.CORE_MAX[dtype]
        if px * py > 1:
            repl_max = min(repl_max, 64)
        while k_cross < nlevels - 1 and sizes[k_cross] <= repl_max:
            k_cross += 1

    # deep-halo geometry per sharded level: halo depth d (bounded by
    # 2*nsmooth+1 -- a full RB sweep consumes 2 halo cells -- and by the
    # block extent along each split axis, since the exchange carries the
    # neighbour's interior), and the per-round sweep schedule.  None: the
    # exchange-per-half-sweep schedule
    def schedule(n, per_round):
        full, rem = divmod(n, per_round)
        return [per_round] * full + ([rem] if rem else [])

    deep_geom = {}
    for k in range(k_cross, nlevels):
        bx, by = sizes[k] // px, sizes[k] // py
        seam = ([bx] if px > 1 else []) + ([by] if py > 1 else [])
        d = min([2 * nsmooth + 1] + seam)
        if comm_mode != "deep" or d < 3:
            deep_geom[k] = None
            continue
        deep_geom[k] = {
            "d": d,
            "dpx": d if px > 1 else 1,
            "dpy": d if py > 1 else 1,
            # rbgs: 2 halo cells per sweep; jacobi/cheb: 1 per step
            "sweeps_rb": schedule(nsmooth, (d - 1) // 2),
            "sweeps_j": schedule(nsmooth_speed, d - 1),
        }

    # the kernel entries of each level's visit in one cycle
    def sweeps(n):            # the colour passes of n iterations (or the
        return 2 * n or 1     # one refresh of none)

    entries = {}
    for k in range(k_cross, nlevels):
        geom = deep_geom[k]
        if k == 0:            # a 1x1 mesh's bottom: smoothing alone
            entries[k] = {"mg_sweep": sweeps(nsmooth_bottom)}
            continue
        fused = geom is not None and use_pallas
        if geom is None:
            e = {"mg_sweep": 2 * sweeps(nsmooth) + 1}
        else:
            rounds = len(geom["sweeps_rb" if smoother == "rbgs"
                              else "sweeps_j"] or [0])
            e = {"mg_deep_smooth": 2 * rounds}
            if not fused:
                e["mg_sweep"] = 1         # the residual and restriction
        e["mg_correct"] = 1
        if k == nlevels - 1 and not fused:
            e["mg_sweep"] = e.get("mg_sweep", 0) + 1   # the top residual
        entries[k] = e
    if k_cross > 0:
        kc, sfx = k_cross - 1, mg_kernel.FLAVOURS[op][0]
        top = nlevels - 1
        while 2 ** (top + 1) > mg_kernel.CORE_MAX[dtype]:
            top -= 1
        peeled = max(0, kc - top)
        entries[kc] = {f"mg_core{sfx}": 1}
        if peeled:
            entries[kc].update({f"mg_down{sfx}": peeled,
                                f"mg_up{sfx}": peeled})
    launches = {}
    for e in entries.values():
        for key, n in e.items():
            launches[key] = launches.get(key, 0) + n
    return types.SimpleNamespace(
        use_pallas=bool(use_pallas), nsmooth_speed=nsmooth_speed,
        k_cross=k_cross, deep_geom=deep_geom, entries=entries,
        launches=launches)


def kernel_flags(bc, px, py, ix, iy):
    """The 8 flags [seam x-lo, x-hi, y-lo, y-hi, own x-lo, x-hi, y-lo,
    y-hi] of block (ix, iy) on a px x py mesh: a seam side has a
    neighbouring block (around the ring on a periodic axis); an axis of one
    block has no seam and owns both its edges."""
    def flags_for(p, idx, lb, rb):
        if p == 1:
            return 0, 0, 1, 1
        seam_l = 1 if lb == "periodic" else int(idx > 0)
        seam_r = 1 if rb == "periodic" else int(idx < p - 1)
        return seam_l, seam_r, int(idx == 0), int(idx == p - 1)

    sxl, sxr, oxl, oxr = flags_for(px, ix, bc.xlb, bc.xrb)
    syl, syr, oyl, oyr = flags_for(py, iy, bc.ylb, bc.yrb)
    return (sxl, sxr, syl, syr, oxl, oxr, oyl, oyr)


class ShardedMG:
    """Multigrid solve of (alpha - beta L) phi = f over a mesh of ranks.

    `mesh` is this rank's parallel.mesh_comm.Mesh; the constructor, like
    `solve`, is collective (every rank calls it).  `solve` runs V-cycles
    exactly like the serial CellCenterMG2d.solve loop (same stall
    detection, same convergence criterion, same smoother ordering).
    `use_pallas` keeps the JAX package's name: True selects the kernel
    structure, False the plain one, None the kernel structure on a CUDA
    mesh with comm_mode "deep" and the plain one otherwise (see the module
    docstring)."""

    def __init__(self, nx, ny, mesh, *,
                 xmin=0.0, xmax=1.0, ymin=0.0, ymax=1.0,
                 xl_BC_type="dirichlet", xr_BC_type="dirichlet",
                 yl_BC_type="dirichlet", yr_BC_type="dirichlet",
                 alpha=0.0, beta=-1.0,
                 nsmooth=10, nsmooth_bottom=50,
                 comm_mode="deep", smoother="rbgs", nsmooth_speed=None,
                 use_pallas=None, verbose=0, dtype=None):
        _check_bcs(xl_BC_type, xr_BC_type, yl_BC_type, yr_BC_type)
        # the serial MG supplies the level grids, the replicated coarse
        # recursion and the operator
        serial = CellCenterMG2d(
            nx, ny, xmin=xmin, xmax=xmax, ymin=ymin, ymax=ymax,
            xl_BC_type=xl_BC_type, xr_BC_type=xr_BC_type,
            yl_BC_type=yl_BC_type, yr_BC_type=yr_BC_type,
            alpha=alpha, beta=beta, nsmooth=nsmooth,
            nsmooth_bottom=nsmooth_bottom, verbose=0, device=mesh.device,
            dtype=dtype)
        self._setup_mesh(serial, mesh, verbose, comm_mode=comm_mode,
                         smoother=smoother, nsmooth_speed=nsmooth_speed,
                         use_pallas=use_pallas)

    # ------------------------------------------------------------------
    # shared mesh / crossover / local-grid set-up
    # ------------------------------------------------------------------
    def _setup_mesh(self, serial, mesh, verbose, *, comm_mode="deep",
                    smoother="rbgs", nsmooth_speed=None, use_pallas=None):
        self.dtype = serial.dtype
        op = mg_kernel.flavour(serial)
        plan = structure(
            serial.nx, serial.ny, mesh.px, mesh.py, dtype=self.dtype,
            op=op, comm_mode=comm_mode,
            smoother=smoother, use_pallas=use_pallas,
            cuda=mesh.device.type == "cuda", nsmooth=serial.nsmooth,
            nsmooth_bottom=serial.nsmooth_bottom,
            nsmooth_speed=nsmooth_speed)
        assert max(plan.deep_geom) == serial.nlevels - 1
        self.plan = plan
        self.use_pallas = plan.use_pallas
        self.serial = serial
        self.mesh = mesh
        self.px, self.py = mesh.px, mesh.py
        self.nx, self.ny = serial.nx, serial.ny
        self.ng = 1
        self.nlevels = serial.nlevels
        self.nsmooth = serial.nsmooth
        self.nsmooth_bottom = serial.nsmooth_bottom
        self.comm_mode = comm_mode
        self.smoother = smoother
        self.nsmooth_speed = plan.nsmooth_speed
        self.verbose = verbose
        self.max_cycles = serial.max_cycles
        self.bc = serial.bc
        self.device = mesh.device
        self.k_cross = plan.k_cross
        self._deep_geom = plan.deep_geom

        # per-level local block grids (levels k_cross-1 .. finest; the
        # k_cross-1 entry gives the shapes of the last local restriction)
        self.local_grids = {}
        for k in range(max(self.k_cross - 1, 0), self.nlevels):
            g = self.serial.grids[k]
            bx, by = g.nx // self.px, g.ny // self.py
            lg = Grid2d(bx, by, ng=self.ng,
                        xmin=0.0, xmax=bx * g.dx, ymin=0.0, ymax=by * g.dy)
            assert abs(lg.dx - g.dx) < 1e-14 * max(1.0, g.dx)
            self.local_grids[k] = lg

        self._flags = kernel_flags(self.bc, self.px, self.py, mesh.ix,
                                   mesh.iy)
        # the operator's coefficient planes on each sharded level's frame
        # (none for the constant operator), and their one-ghost frames
        self._planes = {k: self._coeff_layout(serial.planes[k], k)
                        for k in range(self.k_cross, self.nlevels)} \
            if mg_kernel.FLAVOURS[op][1] else {}
        self._planes1 = self._ng1_frames()

        self.source_norm = 0.0
        self.initialized_rhs = 0
        self.num_cycles = 0
        self.residual_error = 1.e33
        self.relative_error = 1.e33

        self.soln_grid = self.serial.grids[self.nlevels - 1]
        lg = self.local_grids[self.nlevels - 1]
        self.v_int = torch.zeros((lg.nx, lg.ny), dtype=self.dtype,
                                 device=self.device)
        self.f_int = torch.zeros_like(self.v_int)
        self.r_int = None

    # ------------------------------------------------------------------
    # per-level coefficient layouts
    # ------------------------------------------------------------------
    def _block_layout(self, global_arr, level, dpx=None, dpy=None):
        """(..., qx, qy) global padded level-`level` array -> this block's
        (..., bx+2*dpx, by+2*dpy) frame: the neighbours' interior values in
        the seam halos, the serial hierarchy's physical ghosts on the
        domain edges.  The default depth is the standard one ghost;
        positions beyond the global array on a non-periodic axis (physical
        ghosts deeper than one) are zero and never read."""
        lg = self.local_grids[level]
        bx, by = lg.nx, lg.ny
        if dpx is None:
            dpx, dpy = self.ng, self.ng

        def extend(A, dp, dim, periodic):
            """1-ghost global array -> dp-ghost: periodic axes wrap (seam
            halos are globally interior cells, around the domain on a
            periodic axis), non-periodic axes keep the serial depth-1 ghost
            and zero-fill deeper."""
            if dp <= 1:
                return A
            n = A.shape[dim] - 2
            inner = A.narrow(dim, 1, n)
            if periodic:
                return torch.cat([inner.narrow(dim, n - dp, dp), inner,
                                  inner.narrow(dim, 0, dp)], dim)
            shape = list(A.shape)
            shape[dim] = dp - 1
            z = A.new_zeros(shape)
            return torch.cat([z, A.narrow(dim, 0, 1), inner,
                              A.narrow(dim, n + 1, 1), z], dim)

        A = extend(global_arr, dpx, -2, self.bc.xlb == "periodic")
        A = extend(A, dpy, -1, self.bc.ylb == "periodic")
        r0, c0 = self.mesh.ix * bx, self.mesh.iy * by
        return A[..., r0:r0 + bx + 2 * dpx, c0:c0 + by + 2 * dpy].contiguous()

    def _coeff_layout(self, global_arr, level):
        """Block layout of a level's coefficient planes at the level's
        smoothing halo depth (one ghost when it is not deep-smoothed)."""
        geom = self._deep_geom.get(level)
        if geom is None:
            return self._block_layout(global_arr, level)
        return self._block_layout(global_arr, level, geom["dpx"],
                                  geom["dpy"])

    def _ng1_frames(self):
        """Each sharded level's coefficient planes on its one-ghost frame
        (a contiguous copy where the level's frame is deeper), for the
        half-sweep entry."""
        out = {}
        for k, planes in self._planes.items():
            geom = self._deep_geom.get(k)
            if geom is not None:
                lg = self.local_grids[k]
                dpx, dpy = geom["dpx"], geom["dpy"]
                planes = planes[..., dpx - 1:dpx + lg.nx + 1,
                                dpy - 1:dpy + lg.ny + 1].contiguous()
            out[k] = planes
        return out

    # ------------------------------------------------------------------
    # state initialization / access
    # ------------------------------------------------------------------
    def _to_block(self, data):
        """This rank's (bx, by) block of `data`: the global (nx, ny)
        interior, the global (qx, qy) padded array, or the block itself."""
        data = torch.as_tensor(data, dtype=self.dtype, device=self.device)
        g = self.soln_grid
        lg = self.local_grids[self.nlevels - 1]
        if tuple(data.shape) == (g.qx, g.qy):
            data = data[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]
        if tuple(data.shape) == (self.nx, self.ny):
            i0, j0 = self.mesh.ix * lg.nx, self.mesh.iy * lg.ny
            data = data[i0:i0 + lg.nx, j0:j0 + lg.ny]
        elif tuple(data.shape) != (lg.nx, lg.ny):
            raise ValueError(
                f"expected the ({self.nx}, {self.ny}) interior, the "
                f"({g.qx}, {g.qy}) padded array or this rank's "
                f"({lg.nx}, {lg.ny}) block, got {tuple(data.shape)}")
        return data.clone(memory_format=torch.contiguous_format)

    def init_zeros(self):
        self.v_int = torch.zeros_like(self.v_int)

    def init_solution(self, data):
        self.v_int = self._to_block(data)

    def init_RHS(self, data):
        """Set this rank's block of the RHS; the source norm is global."""
        self.f_int = self._to_block(data)
        g = self.soln_grid
        ss = self.mesh.psum(torch.sum(self.f_int ** 2))
        self.source_norm = float(torch.sqrt(g.dx * g.dy * ss))
        self.initialized_rhs = 1

    def get_solution(self):
        """This rank's (bx, by) block of the interior solution."""
        return self.v_int

    def gather_solution(self):
        """The (nx, ny) global interior solution, on every rank (the
        counterpart of np.asarray of the JAX package's sharded array)."""
        return self.mesh.all_gather("y", self.mesh.all_gather(
            "x", self.v_int, 0), 1)

    def get_solution_gradient_interior(self):
        """The centred-difference gradient (gx, gy) on this rank's block
        (the block twin of CellCenterMG2d.get_solution_gradient)."""
        lg = self.local_grids[self.nlevels - 1]
        v = halo_exchange(F.pad(self.v_int, (1, 1, 1, 1)), lg, self.bc,
                          self.mesh)
        vv = ai(v, lg)
        return (0.5 * (vv.ip(1) - vv.ip(-1)) / lg.dx,
                0.5 * (vv.jp(1) - vv.jp(-1)) / lg.dy)

    # ------------------------------------------------------------------
    # deep-halo smoothing
    # ------------------------------------------------------------------
    def _deep_smooth(self, k, v_std, f_deep, geom, emit_last="v"):
        """Deep-halo smoothing at level k: one `deep_smooth` per round,
        each after its own halo exchange; the last round emits
        `emit_last`.

        v_std: the (bx+2, by+2) one-ghost block (its ghosts ignored);
        f_deep: the level's RHS on the deep frame.  Returns (the one-ghost
        block with depth-1 valid ghosts, the restricted residual / the
        owned block's residual / None).  An empty sweep schedule still
        runs one round of no sweeps, for the ghosts (and the emit)."""
        lg = self.local_grids[k]
        bx, by = lg.nx, lg.ny
        dpx, dpy = geom["dpx"], geom["dpy"]
        kw = dict(dpx=dpx, dpy=dpy, d=geom["d"], dx=lg.dx, dy=lg.dy,
                  bc=self.bc, px=self.px, py=self.py, smoother=self.smoother)
        if self._planes:
            kw["planes"] = self._planes[k]
        else:
            # read at every call: the owner may change alpha and beta
            kw["ab"] = (self.serial.alpha, self.serial.beta)
        sweeps = geom["sweeps_rb" if self.smoother == "rbgs"
                      else "sweeps_j"] or [0]
        v_int = v_std[1:-1, 1:-1]
        for i, n_r in enumerate(sweeps):
            # seam halos only: the round's entry refresh fills the
            # physical ghosts
            vd = deep_pad_exchange(v_int, self.bc, self.mesh, dpx, dpy,
                                   phys=False)
            emit = emit_last if i == len(sweeps) - 1 else "v"
            vd, extra = sharded_mg_kernel.deep_smooth(
                vd, f_deep, self._flags, n_sweeps=n_r, emit=emit, **kw)
            v_int = vd[dpx:dpx + bx, dpy:dpy + by]
        if emit_last == "v_r":
            # the residual frame (zero outside the interior) -> owned block
            extra = extra[dpx:dpx + bx, dpy:dpy + by]
        return vd[dpx - 1:dpx + bx + 1, dpy - 1:dpy + by + 1].contiguous(), \
            extra

    def _deep_rhs(self, k, f_std, geom):
        """The level RHS on the deep frame: seam halos exchanged once per
        level visit; physical ghosts are never read."""
        return deep_pad_exchange(f_std[1:-1, 1:-1], self.bc, self.mesh,
                                 geom["dpx"], geom["dpy"], phys=False)

    # ------------------------------------------------------------------
    # the exchange-per-half-sweep schedule
    # ------------------------------------------------------------------
    def _sweep(self, k, v, f, colour=None, emit="v"):
        """One `sweep` call at level k on the one-ghost block v (its seam
        ghosts exchanged): (the frame, its emit or None)."""
        lg = self.local_grids[k]
        kw = dict(colour=colour, dx=lg.dx, dy=lg.dy, bc=self.bc, px=self.px,
                  py=self.py, emit=emit)
        if self._planes1:
            kw["planes"] = self._planes1[k]
        else:
            # read at every call: the owner may change alpha and beta
            kw["ab"] = (self.serial.alpha, self.serial.beta)
        return sharded_mg_kernel.sweep(v, f, self._flags, **kw)

    def _smooth_n(self, k, v, f, n):
        """n red-black iterations at level k, the serial `_smooth_n`'s
        schedule: a colour pass, then the exchange, for each half-sweep
        (the passes fill the physical ghosts, the exchange the seams).
        Returns the block with every ghost valid."""
        v = seam_fill(v, self.bc, self.mesh)
        if n == 0:
            return self._sweep(k, v, f)[0]
        for _ in range(n):
            for colour in (0, 1):
                v = seam_fill(self._sweep(k, v, f, colour)[0], self.bc,
                              self.mesh)
        return v

    # ------------------------------------------------------------------
    # the cycle
    # ------------------------------------------------------------------
    def _replicated_coarse(self, kc, fc_blk):
        """Gather the level-kc RHS blocks into the global problem, solve it
        with the serial V-cycle (identically on every rank) and slice this
        rank's one-ghost block of the correction back out."""
        f_int = self.mesh.all_gather("x", fc_blk[1:-1, 1:-1], 0)
        f_int = self.mesh.all_gather("y", f_int, 1)
        gk = self.serial.grids[kc]
        f_glob = f_int.new_zeros((gk.qx, gk.qy))
        f_glob[gk.ilo:gk.ihi + 1, gk.jlo:gk.jhi + 1] = f_int
        v_glob = mg_kernel.coarse_cycle(self.serial, kc, f_glob)
        bx, by = gk.nx // self.px, gk.ny // self.py
        i0, j0 = self.mesh.ix * bx, self.mesh.iy * by
        return v_glob[i0:i0 + bx + 2, j0:j0 + by + 2].contiguous()

    def _sharded_v_cycle(self, k, v, f, want_top_r=False):
        """V-cycle over the block-partitioned levels (the serial
        CellCenterMG2d._v_cycle's shape).  want_top_r (kernel structure):
        also return the post-smoothing residual of the owned block, from
        the last kernel."""
        if k == 0:
            # only reachable on a 1x1 mesh: the bottom smooth
            return self._smooth_n(0, v, f, self.nsmooth_bottom)
        geom = self._deep_geom.get(k)
        fused = geom is not None and self.use_pallas
        if geom is not None:
            f_deep = self._deep_rhs(k, f, geom)
            v, f_c = self._deep_smooth(k, v, f_deep, geom,
                                       "v_fc" if fused else "v")
        else:
            v = self._smooth_n(k, v, f, self.nsmooth)
        if not fused:
            f_c = self._sweep(k, v, f, emit="v_fc")[1]
        if k - 1 >= self.k_cross:
            v_c = self._sharded_v_cycle(k - 1, torch.zeros_like(f_c), f_c)
        else:
            v_c = self._replicated_coarse(k - 1, f_c)
        v = sharded_mg_kernel.correct(v, v_c)
        if geom is None:
            return self._smooth_n(k, v, f, self.nsmooth)
        # the deep smoother exchanges v itself; no ghost fill needed
        v, r = self._deep_smooth(k, v, f_deep, geom,
                                 "v_r" if fused and want_top_r else "v")
        return (v, r) if want_top_r else v

    def _cycle_local(self, v, f):
        """One V-cycle of the local padded block: (v, the owned block's
        residual)."""
        top = self.nlevels - 1
        if self.use_pallas and self._deep_geom.get(top) is not None:
            # the last round of the finest level returns the residual
            return self._sharded_v_cycle(top, v, f, want_top_r=True)
        v = self._sharded_v_cycle(top, v, f)
        return v, self._sweep(top, v, f, emit="v_r")[1][1:-1, 1:-1]

    def solve_local(self, v, f, rtol, source_norm):
        """The solve loop (V-cycles and the convergence and stall tests) on
        the local (bx+2, by+2) padded blocks v and f, collective over the
        mesh: the norms are global, read once per cycle.  Returns (v, the
        owned block's residual, residual error, relative error, cycles)."""
        g = self.soln_grid
        small = self.serial.small
        denom = source_norm if source_norm != 0.0 else 1.0
        res = rel = 1.e33
        r = torch.zeros_like(v[1:-1, 1:-1])
        cycle, stall = 1, 0
        # the trip count depends on the data (parallel/accounting.py)
        with dynamic_loop():
            while res > rtol and cycle <= self.max_cycles and stall < 2:
                v2, r2 = self._cycle_local(v, f)
                diff = ((v2 - v) / (v2 + small))[1:-1, 1:-1]
                ss = self.mesh.psum(torch.stack([torch.sum(r2 ** 2),
                                                 torch.sum(diff ** 2)]))
                rnorm, rel = torch.sqrt(g.dx * g.dy * ss).tolist()
                new = rnorm / denom
                stall = stall + 1 if new > 0.95 * res else 0
                if self.verbose and self.mesh.ix == 0 and self.mesh.iy == 0:
                    print(f"sharded cycle {cycle}: relative err = {rel}, "
                          f"residual err = {new}")
                v, r, res = v2, r2, new
                cycle += 1
        stats["solves"] += 1
        stats["cycles"] += cycle - 1
        return v, r, res, rel, cycle - 1

    def solve(self, rtol=1.e-11):
        if not self.initialized_rhs:
            msg.fail("ERROR: RHS not initialized")
        v, r, res, rel, ncyc = self.solve_local(
            F.pad(self.v_int, (1, 1, 1, 1)), F.pad(self.f_int, (1, 1, 1, 1)),
            rtol, self.source_norm)
        self.v_int = v[1:-1, 1:-1].contiguous()
        self.r_int = r
        self.num_cycles = ncyc
        self.residual_error = res
        self.relative_error = rel


def make_sharded_mg(*args, **kwargs):
    """A ShardedMG in the kernel structure (its plain versions on the
    CPU).  The solver tiers build their inline MG through this.  There is
    no warm-up and no fallback: a kernel that fails raises."""
    kwargs.setdefault("use_pallas", True)
    return ShardedMG(*args, **kwargs)


class ShardedVarCoeffMG(ShardedMG):
    """Multigrid solve of div(eta grad phi) = f over a mesh of ranks.

    The sharded twin of VarCoeffCCMG2d: the serial instance computes the
    coefficient hierarchy (cell-centred eta restricted down, averaged onto
    edges pre-scaled by 1/dx^2); every sharded level's edge planes are
    then laid out on this block's frame at that level's halo depth.
    `install_coefficients` replaces the hierarchy before a solve (lm_atm's
    projections: the coefficient changes with the density every step)."""

    def __init__(self, nx, ny, mesh, *,
                 xmin=0.0, xmax=1.0, ymin=0.0, ymax=1.0,
                 xl_BC_type="dirichlet", xr_BC_type="dirichlet",
                 yl_BC_type="dirichlet", yr_BC_type="dirichlet",
                 nsmooth=10, nsmooth_bottom=50,
                 coeffs=None, coeffs_bc=None,
                 comm_mode="deep", smoother="rbgs", nsmooth_speed=None,
                 use_pallas=None, verbose=0, dtype=None):
        _check_bcs(xl_BC_type, xr_BC_type, yl_BC_type, yr_BC_type)
        serial = VarCoeffCCMG2d(
            nx, ny, xmin=xmin, xmax=xmax, ymin=ymin, ymax=ymax,
            xl_BC_type=xl_BC_type, xr_BC_type=xr_BC_type,
            yl_BC_type=yl_BC_type, yr_BC_type=yr_BC_type,
            nsmooth=nsmooth, nsmooth_bottom=nsmooth_bottom,
            coeffs=coeffs, coeffs_bc=coeffs_bc, verbose=0,
            device=mesh.device, dtype=dtype)
        self.coeffs_bc = coeffs_bc
        self._setup_mesh(serial, mesh, verbose, comm_mode=comm_mode,
                         smoother=smoother, nsmooth_speed=nsmooth_speed,
                         use_pallas=use_pallas)

    def install_coefficients(self, coeffs):
        """Replace the coefficient hierarchy by that of eta = `coeffs` (the
        global cell-centred eta: the (nx, ny) interior, or a padded frame
        of which the interior is read), on every rank alike: its ghosts
        filled with `coeffs_bc`, restricted down and averaged onto edges
        by the serial construction's arithmetic
        (VarCoeffCCMG2d.set_coefficients), the replicated levels left in
        the serial object (which the coarse core reads at every call), the
        sharded levels laid out on this block's frames, and their one-ghost
        frames rebuilt.  The result equals a fresh
        construction with that eta, bit for bit."""
        self.serial.set_coefficients(coeffs, self.coeffs_bc)
        self._planes = {k: self._coeff_layout(self.serial.planes[k], k)
                        for k in range(self.k_cross, self.nlevels)}
        self._planes1 = self._ng1_frames()


class ShardedGeneralMG(ShardedMG):
    """Multigrid solve of alpha phi + div(beta grad phi) + gamma . grad(phi)
    = f over a mesh of ranks: the sharded twin of GeneralMG2d with
    homogeneous BCs.  `coeffs` is a CellCenterData2d with alpha, beta,
    gamma_x and gamma_y, as for the serial class."""

    def __init__(self, nx, ny, mesh, *,
                 xmin=0.0, xmax=1.0, ymin=0.0, ymax=1.0,
                 xl_BC_type="dirichlet", xr_BC_type="dirichlet",
                 yl_BC_type="dirichlet", yr_BC_type="dirichlet",
                 nsmooth=10, nsmooth_bottom=50,
                 coeffs=None,
                 comm_mode="deep", smoother="rbgs", nsmooth_speed=None,
                 use_pallas=None, verbose=0, dtype=None):
        _check_bcs(xl_BC_type, xr_BC_type, yl_BC_type, yr_BC_type)
        serial = GeneralMG2d(
            nx, ny, xmin=xmin, xmax=xmax, ymin=ymin, ymax=ymax,
            xl_BC_type=xl_BC_type, xr_BC_type=xr_BC_type,
            yl_BC_type=yl_BC_type, yr_BC_type=yr_BC_type,
            nsmooth=nsmooth, nsmooth_bottom=nsmooth_bottom,
            coeffs=coeffs, verbose=0, device=mesh.device, dtype=dtype)
        self._setup_mesh(serial, mesh, verbose, comm_mode=comm_mode,
                         smoother=smoother, nsmooth_speed=nsmooth_speed,
                         use_pallas=use_pallas)
