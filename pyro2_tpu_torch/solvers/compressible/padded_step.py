"""The padded-frame CTU steps: the port of the non-general entries of
pyro2_tpu/solvers/compressible/pallas_step.py.

  make_ctu_step_padded(nx, ny, dx, dy, gamma, rp_params, ivars, stages=4)
      -> (to_padded, from_padded, fill, step)     (make_pallas_ctu_step_padded)
  make_ctu_step(nx, ny, dx, dy, gamma, rp_params, ivars)
      -> step                                      (make_pallas_ctu_step)
  make_ctu_ensemble_step(n_ens, nx, ny, dx, dy, gamma, rp_params, ivars)
      -> (to_padded, from_padded, fill, step)
                                 (make_pallas_ctu_ensemble_step)

Each step is the CTU pipeline with the floor, the external sources, the
sponge and the solid walls off, whatever rp_params says: the JAX package's
_local_step_fn takes those only through keywords, which these entries leave
at their defaults.  So compressible.grav, sponge.do_sponge,
compressible.small_dens and the boundary kinds have no effect here; the
pipeline reads only eos.gamma, compressible.riemann, .limiter,
.use_flattening, .cvisc, .z0, .z1 and .delta from rp_params.  (The gamma
argument reaches in the JAX package only the primitive pressure of the
artificial viscosity's state, which nothing reads; it is accepted and
unused here.)

The frame.  The 128-lane pad and the 8 x-ghost rows of the TPU layout are
Mosaic's constraints, not the step's: the frame here is the plain (nvar,
nx + 2 NG, ny + 2 NG) stack with NG = 4, in the dtype it is given (float64
for parity; the JAX entries cast to float32), and for the ensemble (n_ens,
nvar, qx, qy).  to_padded copies the state into a new frame, from_padded
returns the frame itself, fill fills the periodic ghosts in place with
four strip copies on the device (no host sync) in the JAX order -- the y
lanes first over all rows, then the x rows over the full lane width, so
the corners come from lane-filled rows -- and returns the frame.  step(P,
dt) returns a new frame whose interior is one step on and whose ghosts are
P's (the JAX entries leave the x ghosts of their output unwritten).

For a CUDA frame a step is one launch of the batched entry of
csrc/ctu_step.cu (n_members = 1 for rows 2 and 3, n_ens for row 4),
counted in `launches` under ctu_periodic, ctu_padin and ctu_ensemble.  For
a CPU frame it is the plain step, simulation.plain_step with the same
flags off, member by member.  tile_rows and interpret are TPU tiling and
Pallas options, accepted and ignored.

The stage prefixes.  make_ctu_step_padded(..., stages=s) with s in 1..3
cuts the pipeline short, as the JAX entry's stages does for the JAX
package's benchmark (bench.py differences the prefixes to split a step's
time by stage): step(P, dt) returns a new frame whose interior holds the
sum of the live intermediates at the cut -- ((U_xl + U_xr) + U_yl) + U_yr
of the interface states (1) or of the transversely corrected states (2),
F_x + F_y of the final Riemann pair before the artificial viscosity (3)
-- and whose ghosts are P's.  A CUDA frame launches the stage entry
(ctu_stage_batched_*, counted under ctu_periodic_s1 .. _s3), which takes
four variables (others raise, naming ROADMAP.md A.32); a CPU frame runs
plain_stages.  stages=4 is the whole step.  Any other value raises
ValueError, where the JAX entry runs the whole step (a difference that
ROADMAP.md records under C.4).
"""

import torch

from pyro2_tpu_torch.mesh.grid import Cartesian2d
from pyro2_tpu_torch.solvers.compressible import (ctu_kernel, riemann,
                                                  simulation)
from pyro2_tpu_torch.solvers.compressible import unsplit_fluxes as flx
from pyro2_tpu_torch.util import profile_pyro
from pyro2_tpu_torch.util.runparams import RuntimeParameters

__all__ = ["NG", "STAGES", "launches", "make_ctu_step",
           "make_ctu_step_padded", "make_ctu_ensemble_step", "plain_stages",
           "stages_covered"]

NG = 4

# the pipeline's stages a periodic padded step may stop after (4: the whole
# step)
STAGES = (1, 2, 3, 4)

# kernel launches made through the padded steps, by entry (read by
# chip_smoke.py); the stage prefixes of ctu_periodic count apart
launches = {"ctu_periodic": 0, "ctu_padin": 0, "ctu_ensemble": 0,
            "ctu_periodic_s1": 0, "ctu_periodic_s2": 0,
            "ctu_periodic_s3": 0}


class _Walls:
    xl = xr = yl = yr = 0


def stages_covered(nvar, stages):
    """Raise NotImplementedError unless the stage entry of the CUDA kernel
    takes a frame of nvar variables cut after `stages` (the whole step
    takes 4..MAXVAR)."""
    if stages != 4 and nvar != 4:
        raise NotImplementedError(
            f"the CTU kernel's stage prefixes take 4 variables, not {nvar} "
            "(ROADMAP.md A.32)")


def plain_stages(stages, my_data, rp, ivars):
    """The plain CTU pipeline on my_data.grid cut short after `stages`
    (1..3), with the padded entries' flags (no floor, sources, sponge or
    walls; Cartesian): step(U, t, dt) -> a new frame holding on the
    interior the sum _local_step_fn returns in its order, ((U_xl + U_xr) +
    U_yl) + U_yr of the interface states (1) or of the transversely
    corrected states (2), F_x + F_y of the final Riemann pair (3), and
    U's ghosts elsewhere."""
    myg = my_data.grid
    tc = profile_pyro.TimerCollection()
    iv = (slice(None), slice(myg.ilo, myg.ihi + 1),
          slice(myg.jlo, myg.jhi + 1))

    def step(U, t, dt):
        U_xl, U_xr, U_yl, U_yr = flx.interface_states(U, my_data, rp, ivars,
                                                      tc, dt)
        if stages >= 2:
            U_xl, U_xr, U_yl, U_yr = flx.apply_transverse_flux(
                U_xl, U_xr, U_yl, U_yr, my_data, rp, ivars, _Walls(), tc,
                dt)
        if stages == 3:
            F_x = riemann.riemann_flux(1, U_xl, U_xr, my_data, rp, ivars,
                                       0, 0, tc)
            F_y = riemann.riemann_flux(2, U_yl, U_yr, my_data, rp, ivars,
                                       0, 0, tc)
            total = F_x + F_y
        else:
            total = U_xl + U_xr + U_yl + U_yr
        out = U.clone()
        out[iv] = total[iv]
        return out

    return step


class PaddedStep:
    """step(P, dt) -> P_new over frames of `shape` ((nvar, qx, qy), or
    (n_members, nvar, qx, qy) when batched), counted under `name`; with
    stages 1..3 the pipeline's prefix (plain_stages)."""

    def __init__(self, name, nx, ny, dx, dy, rp_params, ivars,
                 n_members=None, stages=4):
        if stages not in STAGES:
            raise ValueError(f"stages is one of {STAGES}, not {stages!r}")
        rp = RuntimeParameters()
        rp.params = dict(rp_params)
        method = rp.get_param("compressible.riemann")
        if method not in ctu_kernel.RIEMANN:
            raise ValueError(f"unknown Riemann solver {method}")
        ctu_kernel.covered(ivars, NG)

        class _Data:
            grid = Cartesian2d(nx, ny, ng=NG, xmax=nx * dx, ymax=ny * dy)

        g = _Data.grid
        self.name = name
        self.stages = stages
        self.batched = n_members is not None
        self.n_members = n_members or 1
        frame = (ivars.nvar, g.qx, g.qy)
        self.shape = (n_members,) + frame if self.batched else frame
        if stages == 4:
            self.plain_one = simulation.plain_step(
                _Data(), rp, ivars, _Walls(), profile_pyro.TimerCollection())
        else:
            self.plain_one = plain_stages(stages, _Data(), rp, ivars)
        self._ints = [ivars.nvar, nx, ny, NG,
                      ivars.idens, ivars.ixmom, ivars.iymom, ivars.iener,
                      ctu_kernel.RIEMANN[method],
                      rp.get_param("compressible.limiter"),
                      int(bool(rp.get_param("compressible.use_flattening"))),
                      0, 0, 0,        # sources, sponge, floor: off
                      0, 0, 0, 0,     # solid walls: none
                      0, 0]           # Cartesian, no problem source
        self._doubles = [g.dx, g.dy, 0.0,  # dt, set per call
                         rp.get_param("eos.gamma"),
                         rp.get_param("compressible.z0"),
                         rp.get_param("compressible.z1"),
                         rp.get_param("compressible.delta"),
                         rp.get_param("compressible.cvisc"),
                         0.0, 0.0, 0.0, 0.0, 0.0,  # floor, grav, sponge
                         0.0]                      # e_rate

    def check(self, P):
        if not isinstance(P, torch.Tensor):
            raise TypeError("the padded step takes a torch.Tensor")
        if P.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {P.device}")
        if P.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"unsupported dtype {P.dtype}")
        if tuple(P.shape) != self.shape:
            raise ValueError(f"frame shape {tuple(P.shape)} is not "
                             f"{self.shape}")
        if not P.is_contiguous():
            raise ValueError("the frame must be contiguous")

    def __call__(self, P, dt):
        self.check(P)
        if P.device.type == "cpu":
            return self.plain(P, dt)
        return self.launch(P, dt)

    def plain(self, P, dt):
        """The plain step (or prefix) of each member (any device)."""
        if not self.batched:
            return self.plain_one(P, None, float(dt))
        return torch.stack([self.plain_one(U, None, float(dt)) for U in P])

    def launch(self, P, dt):
        """One launch of the CUDA kernel on the frame."""
        self.check(P)
        stages_covered(self.shape[-3], self.stages)
        doubles = list(self._doubles)
        doubles[2] = float(dt)
        out = ctu_kernel.launch_batched(P, self._ints, doubles,
                                        self.n_members, self.stages)
        launches[self.name] += 1
        return out


def _fill(nx, ny):
    """The periodic ghost fill of a frame (the last two axes), in place."""
    def fill(P):
        # lane (y) ghosts first, over all rows, so the row copies below
        # carry complete lane-filled strips into the x ghosts (corners)
        P[..., 0:NG].copy_(P[..., ny:ny + NG])
        P[..., NG + ny:2 * NG + ny].copy_(P[..., NG:2 * NG])
        # row (x) ghosts, full lane width
        P[..., 0:NG, :].copy_(P[..., nx:nx + NG, :])
        P[..., NG + nx:2 * NG + nx, :].copy_(P[..., NG:2 * NG, :])
        return P
    return fill


def make_ctu_step_padded(nx, ny, dx, dy, gamma, rp_params, ivars,
                         tile_rows=128, interpret=False, stages=4):
    """Periodic CTU stepping on a persistent frame: (to_padded,
    from_padded, fill, step); a step is one ctu_periodic launch, or with
    stages 1..3 one launch of the prefix, counted under ctu_periodic_s<n>
    (see the module's docstring)."""
    name = "ctu_periodic" if stages == 4 else f"ctu_periodic_s{stages}"
    step = PaddedStep(name, nx, ny, dx, dy, rp_params, ivars, stages=stages)
    fill = _fill(nx, ny)

    def to_padded(U):
        return U.contiguous().clone()

    def from_padded(P):
        return P

    return to_padded, from_padded, fill, step


def make_ctu_step(nx, ny, dx, dy, gamma, rp_params, ivars, tile_rows=8):
    """(U_padded, dt) -> U_padded, the (nvar, nx + 2 NG, ny + 2 NG) state
    with its ghosts filled: the interior one step on, the ghosts kept.  A
    step is one ctu_padin launch."""
    return PaddedStep("ctu_padin", nx, ny, dx, dy, rp_params, ivars)


def make_ctu_ensemble_step(n_ens, nx, ny, dx, dy, gamma, rp_params, ivars,
                           tile_rows=128, interpret=False):
    """Periodic CTU stepping of n_ens same-shape states at once: (to_padded,
    from_padded, fill, step) over (n_ens, nvar, qx, qy) frames; a step is
    one ctu_ensemble launch, whatever n_ens is, and each member's result
    is its own step's."""
    step = PaddedStep("ctu_ensemble", nx, ny, dx, dy, rp_params, ivars,
                      n_members=n_ens)
    fill = _fill(nx, ny)
    fill.batched = True

    def to_padded(Us):
        return Us.contiguous().clone()

    def from_padded(P):
        return P

    return to_padded, from_padded, fill, step
