"""The low-Mach atmospheric solver over a mesh of ranks.

The port of pyro2_tpu/parallel/sharded_lm_atm.py.  One rank owns one block
of the (8, nx, ny) interior (density, x- and y-velocity, eint, phi-MAC,
phi, gradp_x, gradp_y) and runs the serial step's stages on its padded
block (ng = 4): the limited slopes, the three interface stages of
`lm_kernel.LMInterface` on the block grid (`k_lm_mac`, `k_lm_rho` and
`k_lm_states` on CUDA, rows 7 of PERF.md section 6; their plain versions
on the CPU), the provisional and final updates.  Both variable-
coefficient projections of a step (the MAC and the final one), and the
preevolve's initial one, run inline through one `ShardedVarCoeffMG`
(`ShardedMG.solve_local`: `k_deep` at ncoef 2 and `k_correct` on the
sharded levels, `mg_core_vc` for the replicated coarse levels; rows 18, 19
and 13).

The projection coefficient beta0^2 / rho follows the density, so each
projection installs its own hierarchy first, where the serial solver
builds a VarCoeffCCMG2d: the density's interior is gathered on every rank
(O(nx ny) a rank a projection, as in JAX), beta0^2 / rho formed and
`ShardedVarCoeffMG.install_coefficients` lays it out.  A step:

  fill -> slopes -> MAC velocities -> [install from rho^n] MAC projection
  -> MAC correction -> seam exchange of the corrected faces -> rho
  advection -> eint -> [install from rho^n+1] interface states ->
  provisional update -> time-centred buoyancy -> final projection ->
  velocity and gradp update

The corrected MAC faces are exchanged across the seams before the rho and
state stages read them (two faces deep beyond the block): a seam ghost
face is a global interior face, which the serial array holds corrected;
the domain edges keep their local values, as the serial array does.

The 1-D hydrostatic base state is global O(ny) data (the bubble's lateral
mean and HSE integral), so one global serial Simulation gives the initial
state and the base state at construction, and every rank keeps its block
row's window of rho0, p0, beta0 and beta0-edges (by + 2 ng rows).  dt is
the serial rule on the block maxima reduced with `Mesh.pmax` (exact).

The arithmetic is the port's serial Simulation's (solvers/lm_atm), which
differs from JAX's sharded jnp path where the port's serial solver does:
the density increment comes from `rho_increment`.  The solves sum their
norms over the ranks, which may round apart from the serial sums, so a run
equals the serial one to roundoff.  There is no fallback: a kernel that
fails raises (JAX's TPU `try`/`except` around the fused multigrid is not
carried over).

Refused, as in JAX: a grid that does not divide over the mesh, and a
domain edge other than periodic, reflect and outflow (the serial solver's
kinds; JAX refuses the same ones through the multigrid's BC check).
"""

import importlib

import numpy as np
import torch
import torch.nn.functional as F

from pyro2_tpu_torch.mesh import reconstruction
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.parallel.blocks import adopt_block_grid, gather_interior
from pyro2_tpu_torch.parallel.mesh_comm import (gated_physical_fill,
                                                halo_exchange,
                                                halo_exchange_stack,
                                                seam_exchange)
from pyro2_tpu_torch.parallel.sharded_incompressible import solve_inline
from pyro2_tpu_torch.parallel.sharded_mg import ShardedVarCoeffMG
from pyro2_tpu_torch.solvers.lm_atm.lm_kernel import LMInterface
from pyro2_tpu_torch.solvers.lm_atm.simulation import Basestate

__all__ = ["ShardedLMAtm"]

# the domain edges the path takes: the serial solver's (its phi edges are
# periodic, Neumann or Dirichlet, which the sharded multigrid takes, and
# the exchange fills the state's periodic, reflecting and outflow edges)
_BCS = ("periodic", "reflect", "outflow")


class ShardedLMAtm:
    """Block-partitioned low-Mach atmospheric flow.

    `U_int` is this rank's (8, bx, by) block of the interior, on the mesh's
    device in `dtype` (its working dtype by default).  The stepping methods
    mirror the serial Simulation's (method_compute_timestep, preevolve,
    evolve) and are collective."""

    NG = 4

    def __init__(self, rp, mesh, *, problem="bubble", dtype=None):
        from pyro2_tpu_torch.solvers import lm_atm

        self.rp = rp
        self.mesh = mesh
        self.px, self.py = mesh.px, mesh.py
        nx, ny = rp.get_param("mesh.nx"), rp.get_param("mesh.ny")
        if nx % self.px != 0 or ny % self.py != 0:
            raise ValueError("grid must divide evenly over the device mesh")
        self.nx, self.ny = nx, ny
        bx, by = nx // self.px, ny // self.py

        for edge in ("xl", "xr", "yl", "yr"):
            kind = rp.get_param(f"mesh.{edge}boundary")
            if kind not in _BCS:
                raise ValueError(
                    f"boundary '{kind}' is not supported by the sharded "
                    f"lm_atm path (it takes {', '.join(_BCS)})")
        problem_mod = importlib.import_module(
            f"pyro2_tpu_torch.solvers.lm_atm.problems.{problem}")
        for k, v in getattr(problem_mod, "PROBLEM_PARAMS", {}).items():
            if k not in rp.params:
                rp.set_param(k, v, no_new=False)

        # one global serial Simulation: the initial state and the base
        # state, whose lateral mean and HSE integral are global
        gsim = lm_atm.Simulation("lm_atm", problem, problem_mod.init_data,
                                 rp, device=mesh.device, dtype=dtype)
        gsim.initialize()
        self.dtype = gsim.dtype
        cc = gsim.cc_data
        gg = cc.grid
        self.names = list(cc.names)
        self.bcs = [cc.BCs[n] for n in self.names]
        (self.irho, self.iu, self.iv, self.iei, self.ipm, self.iph,
         self.igx, self.igy) = (self.names.index(n) for n in (
             "density", "x-velocity", "y-velocity", "eint", "phi-MAC", "phi",
             "gradp_x", "gradp_y"))
        self.bc_dens = cc.BCs["density"]
        self.bc_yodd = cc.BCs["y-velocity"]
        bc_phi = cc.BCs["phi"]

        # the block grid: the global dx and dy, bitwise-global coordinates
        ng = self.NG
        self.lg4 = adopt_block_grid(Grid2d(bx, by, ng=ng), rp, mesh)
        self.lm = LMInterface(self.lg4)

        # this block row's window of the base state, host and device
        self.base = {}
        for name, b in gsim.base.items():
            w = Basestate(by, ng=ng)
            w.d = np.array(b.d[mesh.iy * by:mesh.iy * by + by + 2 * ng])
            self.base[name] = w
        self._beta0_int = self._t(gsim.base["beta0"].v2d())

        # one sharded vc multigrid (phi and phi-MAC share bc_phi) in the
        # kernel structure (make_sharded_mg's rule); each projection
        # installs its own coefficients
        rho = cc.get_var("density")
        self.smg = ShardedVarCoeffMG(
            nx, ny, mesh, xmin=gg.xmin, xmax=gg.xmax, ymin=gg.ymin,
            ymax=gg.ymax, xl_BC_type=bc_phi.xlb, xr_BC_type=bc_phi.xrb,
            yl_BC_type=bc_phi.ylb, yr_BC_type=bc_phi.yrb,
            coeffs=(1.0 / rho) * self._t(gsim.base["beta0"].full2d()) ** 2,
            coeffs_bc=self.bc_dens, use_pallas=True, dtype=self.dtype)

        i0, j0 = gg.ilo + mesh.ix * bx, gg.jlo + mesh.iy * by
        self.U_int = cc.data[:, i0:i0 + bx, j0:j0 + by].contiguous()

        self.limiter = rp.get_param("lm-atmosphere.limiter")
        self.proj_type = rp.get_param("lm-atmosphere.proj_type")
        self.grav = rp.get_param("lm-atmosphere.grav")
        self.gamma = rp.get_param("eos.gamma")
        self.cfl = rp.get_param("driver.cfl")
        self.t = 0.0
        self.n = 0
        self.dt = None

    # -- helpers --------------------------------------------------------------
    def _t(self, a):
        """A host profile as a tensor of the working device and dtype."""
        return torch.as_tensor(a, dtype=self.dtype, device=self.mesh.device)

    def _b(self, name, view="full2d", *args):
        """A window of the base state as a tensor (Basestate's views)."""
        return self._t(getattr(self.base[name], view)(*args))

    def _valid(self):
        g = self.lg4
        return (slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))

    def _filled(self, U_int):
        """The padded block of an interior block, every variable's ghosts
        filled by halo exchange (fill_BC_all before a serial step)."""
        ng = self.NG
        return halo_exchange_stack(F.pad(U_int, (ng,) * 4), self.lg4,
                                   self.bcs, self.mesh)

    def _gated(self, a, bc):
        """A field whose seam ghosts hold their pointwise values: the
        physical fill on the blocks that own a domain edge (the serial
        aux fill_BC)."""
        return gated_physical_fill(a, self.lg4, bc, self.mesh.owned_edges)

    def _install(self, rho_int):
        """Install the projection coefficient beta0^2 / rho of the global
        density gathered from every rank's interior block (collective)."""
        rho = gather_interior(rho_int, self.mesh)
        self.smg.install_coefficients((1.0 / rho) * self._beta0_int ** 2)

    def _gradient(self, phi1):
        """The centred gradient of a (bx+2, by+2) solution block (the
        serial get_solution_gradient)."""
        g = self.smg.soln_grid
        pv = ai(phi1, self.smg.local_grids[self.smg.nlevels - 1])
        return (0.5 * (pv.ip(1) - pv.ip(-1)) / g.dx,
                0.5 * (pv.jp(1) - pv.jp(-1)) / g.dy)

    def _div_beta_U(self, u, v):
        """Cell-centred div(beta0 U) on the block interior (the serial
        _cc_div_beta_U)."""
        g = self.lg4
        uv, vv = ai(u, g), ai(v, g)
        return (0.5 * self._b("beta0", "v2d") *
                (uv.ip(1) - uv.ip(-1)) / g.dx +
                0.5 * (self._b("beta0", "v2dp", 1) * vv.jp(1) -
                       self._b("beta0", "v2dp", -1) * vv.jp(-1)) / g.dy)

    # -- the step -------------------------------------------------------------
    def _step(self, U_int, dt):
        """One low-Mach step of this rank's interior block (the serial
        evolve)."""
        g = self.lg4
        ng = self.NG
        sl = self._valid()
        U = self._filled(U_int)
        rho, u, v = U[self.irho], U[self.iu], U[self.iv]
        gradp_x, gradp_y = U[self.igx].clone(), U[self.igy].clone()
        phi = U[self.iph]
        beta0_2d = self._b("beta0")
        rho0_2d = self._b("rho0")
        grav = self.grav

        lim = self.limiter
        ldelta_rx = reconstruction.limit(rho, g, 1, lim)
        ldelta_ux = reconstruction.limit(u, g, 1, lim)
        ldelta_vx = reconstruction.limit(v, g, 1, lim)
        ldelta_ry = reconstruction.limit(rho, g, 2, lim)
        ldelta_uy = reconstruction.limit(u, g, 2, lim)
        ldelta_vy = reconstruction.limit(v, g, 2, lim)

        # the MAC velocities
        coeff = self._gated((1.0 / rho) * beta0_2d, self.bc_dens)
        source = self._gated((rho - rho0_2d) * grav / rho, self.bc_yodd)
        u_MAC, v_MAC = self.lm.mac_vels(
            dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy,
            coeff * gradp_x, coeff * gradp_y, source)

        # the MAC projection
        self._install(U_int[self.irho])
        um, vm = ai(u_MAC, g), ai(v_MAC, g)
        div_v = (self._b("beta0", "v2d") * (um.ip(1) - um.v()) / g.dx +
                 (self._b("beta0-edges", "v2dp", 1) * vm.jp(1) -
                  self._b("beta0-edges", "v2d") * vm.v()) / g.dy)
        f = F.pad(div_v, (1, 1, 1, 1))
        phi_MAC = F.pad(solve_inline(self.smg, torch.zeros_like(f), f,
                                     1.e-12), (ng - 1,) * 4)

        cv, pm = ai(coeff, g), ai(phi_MAC, g)
        bx = (0, 1, 0, 0)
        coeff_x = 0.5 * (cv.ip(-1, buf=bx) + cv.v(buf=bx))
        u_MAC[g.ilo:g.ihi + 2, g.jlo:g.jhi + 1] += \
            -coeff_x * (pm.v(buf=bx) - pm.ip(-1, buf=bx)) / g.dx
        by = (0, 0, 0, 1)
        coeff_y = 0.5 * (cv.jp(-1, buf=by) + cv.v(buf=by))
        v_MAC[g.ilo:g.ihi + 1, g.jlo:g.jhi + 2] += \
            -coeff_y * (pm.v(buf=by) - pm.jp(-1, buf=by)) / g.dy
        # the seam ghosts of the corrected faces, which the rho and state
        # stages read
        u_MAC = seam_exchange(u_MAC, g, self.mesh)
        v_MAC = seam_exchange(v_MAC, g, self.mesh)

        # rho advection and the diagnostic eint
        rho_old = rho
        rho = rho_old.clone()
        rho[sl] += self.lm.rho_increment(dt, rho_old, u_MAC, v_MAC,
                                         ldelta_rx, ldelta_ry)
        rho = halo_exchange(rho, g, self.bc_dens, self.mesh)
        eint = self._b("p0") / (self.gamma - 1.0) / rho

        # the interface states and the provisional update
        coeff = self._gated((2.0 / (rho + rho_old)) * beta0_2d, self.bc_dens)
        advect_x, advect_y = self.lm.advect_terms(
            dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy,
            coeff * gradp_x, coeff * gradp_y, source, u_MAC, v_MAC)
        u = u.clone()
        v = v.clone()
        if self.proj_type == 1:
            u[sl] += -dt * (advect_x + ai(gradp_x, g).v())
            v[sl] += -dt * (advect_y + ai(gradp_y, g).v())
        elif self.proj_type == 2:
            u[sl] += -dt * advect_x
            v[sl] += -dt * advect_y

        # the time-centred buoyancy
        rho_half = 0.5 * (rho + rho_old)
        source = self._gated((rho_half - rho0_2d) * grav / rho_half,
                             self.bc_yodd)
        v = v + dt * source
        u = halo_exchange(u, g, self.bcs[self.iu], self.mesh)
        v = halo_exchange(v, g, self.bcs[self.iv], self.mesh)

        # the final projection, from the last phi
        self._install(rho[sl])
        f = F.pad(self._div_beta_U(u, v) / dt, (1, 1, 1, 1))
        phi = solve_inline(self.smg, phi[ng - 1:-(ng - 1), ng - 1:-(ng - 1)],
                           f, 1.e-12)
        gphi_x, gphi_y = self._gradient(phi)
        coeff_b = ((1.0 / rho) * beta0_2d)[sl]
        u[sl] += -dt * (coeff_b * gphi_x)
        v[sl] += -dt * (coeff_b * gphi_y)
        if self.proj_type == 1:
            gradp_x[sl] += gphi_x
            gradp_y[sl] += gphi_y
        elif self.proj_type == 2:
            gradp_x[sl] = gphi_x
            gradp_y[sl] = gphi_y

        U = U.clone()
        U[self.irho], U[self.iei] = rho, eint
        U[self.iu], U[self.iv] = u, v
        U[self.ipm] = phi_MAC
        U[self.iph] = F.pad(phi, (ng - 1,) * 4)
        U[self.igx], U[self.igy] = gradp_x, gradp_y
        return U[:, ng:-ng, ng:-ng].contiguous()

    def _preproj(self, U_int):
        """The preevolve's initial projection (rtol 1e-10): the velocity
        made to satisfy the constraint, phi its potential."""
        ng = self.NG
        sl = self._valid()
        U = self._filled(U_int)
        rho, u, v = U[self.irho], U[self.iu].clone(), U[self.iv].clone()
        self._install(U_int[self.irho])
        f = F.pad(self._div_beta_U(u, v), (1, 1, 1, 1))
        phi0 = solve_inline(self.smg, torch.zeros_like(f), f, 1.e-10)
        gx, gy = self._gradient(phi0)
        coeff_b = ((1.0 / rho) * self._b("beta0"))[sl]
        u[sl] = u[sl] - coeff_b * gx
        v[sl] = v[sl] - coeff_b * gy
        U[self.iu], U[self.iv] = u, v
        U[self.iph] = F.pad(phi0, (ng - 1,) * 4)
        return U[:, ng:-ng, ng:-ng].contiguous()

    # -- the stepping methods (the serial Simulation's) -----------------------
    def method_compute_timestep(self):
        """The CFL dt and the buoyancy-limited dt: the serial rule on the
        block maxima (the test for a moving fluid over every padded cell,
        the CFL over the interior), reduced with Mesh.pmax."""
        g = self.lg4
        U = self._filled(self.U_int)
        u, v, rho = U[self.iu], U[self.iv], U[self.irho]
        uv, vv = ai(u, g).v().abs(), ai(v, g).v().abs()
        F_buoy = (ai((rho - self._b("rho0")) * self.grav, g).v().abs() /
                  ai(rho, g).v())
        umax, vmax, uint, vint, fmax = self.mesh.pmax(torch.stack([
            u.abs().max(), v.abs().max(), uv.max(), vv.max(),
            F_buoy.max()])).tolist()
        xtmp = ytmp = 1.e33
        if umax != 0:
            xtmp = g.dx / uint
        if vmax != 0:
            ytmp = g.dy / vint
        dt = self.cfl * min(xtmp, ytmp)
        self.dt = min(dt, np.sqrt(2.0 * g.dx / fmax))

    def preevolve(self):
        """The initial projection, then one throwaway step for gradp at
        n - 1/2, of which only gradp is kept."""
        self.U_int = self._preproj(self.U_int)
        self.method_compute_timestep()
        evolved = self._step(self.U_int, self.dt)
        U = self.U_int.clone()
        U[self.igx] = evolved[self.igx]
        U[self.igy] = evolved[self.igy]
        self.U_int = U

    def evolve(self):
        self.U_int = self._step(self.U_int, self.dt)
        self.t += self.dt
        self.n += 1

    def get_var(self, name):
        """This rank's (bx, by) block of one variable's interior."""
        return self.U_int[self.names.index(name)]

    def gather(self):
        """The (8, nx, ny) global interior, on every rank (collective)."""
        return gather_interior(self.U_int, self.mesh)
