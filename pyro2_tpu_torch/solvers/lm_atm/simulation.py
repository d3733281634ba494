"""Low-Mach atmospheric Simulation (Maestro-like).

The port of pyro2_tpu/solvers/lm_atm/simulation.py: a 1-D hydrostatic base
state (rho0, p0, beta0 = p0^(1/gamma)) in host numpy float64, with
variable-coefficient projections D(beta0^2/rho) G(phi/beta0) = D(beta0 U)
on the coefficient multigrid (multigrid/variable_coeff_MG.py), whose
V-cycles go through the CUDA `vc` kernels on the GPU.  The three interface
stages of a step (MAC velocities, rho advection, the advective terms of u
and v) go through lm_kernel.LMInterface: the CUDA lm_interface kernels for
CUDA tensors, their plain versions for CPU tensors.

The state container is written in place (set_var, fill_BC), so a step
works on copies of the fields it reads at its start.
"""

import numpy as np
import torch

import pyro2_tpu_torch.mesh.boundary as bnd
import pyro2_tpu_torch.multigrid.variable_coeff_MG as vcMG
from pyro2_tpu_torch.mesh import patch, reconstruction
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.simulation_null import (NullSimulation, bc_setup,
                                             grid_setup)
from pyro2_tpu_torch.solvers.lm_atm import lm_kernel


class Basestate:
    """A 1-D vertical base-state profile with ghost cells (host numpy)."""

    def __init__(self, ny, *, ng=0):
        self.ny = ny
        self.ng = ng
        self.qy = ny + 2 * ng
        self.d = np.zeros((self.qy), dtype=np.float64)
        self.jlo = ng
        self.jhi = ng + ny - 1

    def v(self, buf=0):
        return self.d[self.jlo - buf:self.jhi + 1 + buf]

    def v2d(self, buf=0):
        """Broadcastable (1, ny+2buf) row view."""
        return self.d[np.newaxis, self.jlo - buf:self.jhi + 1 + buf]

    def v2dp(self, shift, buf=0):
        return self.d[np.newaxis,
                      self.jlo + shift - buf:self.jhi + 1 + shift + buf]

    def jp(self, shift, buf=0):
        return self.d[self.jlo - buf + shift:self.jhi + 1 + buf + shift]

    def full2d(self):
        """Broadcastable (1, qy) row of the whole padded profile."""
        return self.d[np.newaxis, :]


class Simulation(NullSimulation):

    def __init__(self, solver_name, problem_name, problem_func, rp, *,
                 problem_finalize_func=None, problem_source_func=None,
                 problem_source_weight_func=None, timers=None, device=None,
                 dtype=None):
        super().__init__(
            solver_name, problem_name, problem_func, rp,
            problem_finalize_func=problem_finalize_func,
            problem_source_func=problem_source_func,
            problem_source_weight_func=problem_source_weight_func,
            timers=timers, device=device, dtype=dtype)
        self.base = {}
        self.aux_data = None
        self.in_preevolve = False
        self.lm = None

    def _t(self, a):
        """A host profile as a tensor of the working device and dtype."""
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def initialize(self):
        """Grid (ng=4), state + projection fields, 1-D base state, ICs."""
        myg = grid_setup(self.rp, ng=4)
        bc_dens, bc_xodd, bc_yodd = bc_setup(self.rp)

        my_data = self.data_class(myg)
        my_data.register_var("density", bc_dens)
        my_data.register_var("x-velocity", bc_xodd)
        my_data.register_var("y-velocity", bc_yodd)
        my_data.register_var("eint", bc_dens)  # diagnostic only

        # phi BCs: Neumann at walls/inflow, Dirichlet at outflow
        bcs = []
        for bc in [self.rp.get_param("mesh.xlboundary"),
                   self.rp.get_param("mesh.xrboundary"),
                   self.rp.get_param("mesh.ylboundary"),
                   self.rp.get_param("mesh.yrboundary")]:
            if bc == "periodic":
                bcs.append("periodic")
            elif bc in ["reflect", "slipwall"]:
                bcs.append("neumann")
            elif bc in ["outflow"]:
                bcs.append("dirichlet")
            else:
                bcs.append(None)
        bc_phi = bnd.BC(xlb=bcs[0], xrb=bcs[1], ylb=bcs[2], yrb=bcs[3])

        my_data.register_var("phi-MAC", bc_phi)
        my_data.register_var("phi", bc_phi)
        my_data.register_var("gradp_x", bc_dens)
        my_data.register_var("gradp_y", bc_dens)
        my_data.create()
        self.cc_data = my_data

        aux_data = self.data_class(myg)
        aux_data.register_var("coeff", bc_dens)
        aux_data.register_var("source_y", bc_yodd)
        aux_data.create()
        self.aux_data = aux_data

        self.base["rho0"] = Basestate(myg.ny, ng=myg.ng)
        self.base["p0"] = Basestate(myg.ny, ng=myg.ng)

        self.problem_func(self.cc_data, self.base, self.rp)

        # beta0 = p0^(1/gamma), plus edge-centered values
        gamma = self.rp.get_param("eos.gamma")
        self.base["beta0"] = Basestate(myg.ny, ng=myg.ng)
        self.base["beta0"].d[:] = self.base["p0"].d ** (1.0 / gamma)

        self.base["beta0-edges"] = Basestate(myg.ny, ng=myg.ng)
        self.base["beta0-edges"].jp(1)[:] = \
            0.5 * (self.base["beta0"].v() + self.base["beta0"].jp(1))
        self.base["beta0-edges"].d[myg.jlo] = self.base["beta0"].d[myg.jlo]
        self.base["beta0-edges"].d[myg.jhi + 1] = \
            self.base["beta0"].d[myg.jhi]

        self.lm = lm_kernel.LMInterface(myg)

    def make_prime(self, a, a0):
        """Subtract the base-state profile: a' = a - a0(y)."""
        return a - self._t(a0.full2d())

    def method_compute_timestep(self):
        """CFL dt plus the buoyancy-limited dt (for U ~ 0 starts)."""
        myg = self.cc_data.grid
        cfl = self.rp.get_param("driver.cfl")

        u = self.cc_data.get_var("x-velocity")
        v = self.cc_data.get_var("y-velocity")

        # the test for a moving fluid looks at every cell, ghosts included;
        # the CFL then at the interior
        xtmp = ytmp = 1.e33
        umax = float(u.abs().max())
        vmax = float(v.abs().max())
        if umax != 0:
            xtmp = myg.dx / float(ai(u, myg).v().abs().max())
        if vmax != 0:
            ytmp = myg.dy / float(ai(v, myg).v().abs().max())
        dt = cfl * min(xtmp, ytmp)

        rho = self.cc_data.get_var("density")
        rho0 = self.base["rho0"]
        rhoprime = self.make_prime(rho, rho0)
        g = self.rp.get_param("lm-atmosphere.grav")
        F_buoy = float((ai(rhoprime * g, myg).v().abs() /
                        ai(rho, myg).v()).max())
        dt_buoy = np.sqrt(2.0 * myg.dx / F_buoy)

        self.dt = min(dt, dt_buoy)
        if self.verbose > 0:
            print(f"timestep is {self.dt}")

    def _vc_mg(self, phi_var, coeff):
        myg = self.cc_data.grid
        bcs = self.cc_data.BCs[phi_var]
        return vcMG.VarCoeffCCMG2d(myg.nx, myg.ny,
                                   xl_BC_type=bcs.xlb, xr_BC_type=bcs.xrb,
                                   yl_BC_type=bcs.ylb, yr_BC_type=bcs.yrb,
                                   xmin=myg.xmin, xmax=myg.xmax,
                                   ymin=myg.ymin, ymax=myg.ymax,
                                   coeffs=coeff,
                                   coeffs_bc=self.cc_data.BCs["density"],
                                   verbose=0, device=self.device,
                                   dtype=self.dtype)

    def _cc_div_beta_U(self, u, v, beta0, target_grid):
        """Cell-centered div(beta0 U) on target_grid's padded shape (the
        MG's ng=1 grid)."""
        myg = self.cc_data.grid
        uv = ai(u, myg)
        vv = ai(v, myg)
        div_v = (0.5 * self._t(beta0.v2d()) *
                 (uv.ip(1) - uv.ip(-1)) / myg.dx +
                 0.5 * (self._t(beta0.v2dp(1)) * vv.jp(1) -
                        self._t(beta0.v2dp(-1)) * vv.jp(-1)) / myg.dy)
        out = target_grid.scratch_array(dtype=self.dtype, device=self.device)
        out[target_grid.ilo:target_grid.ihi + 1,
            target_grid.jlo:target_grid.jhi + 1] = div_v
        return out

    def _set_filled(self, data, name, value):
        """Set a variable, fill its ghosts, and return a copy of it."""
        data.set_var(name, value)
        data.fill_BC(name)
        return data.get_var(name).clone()

    def preevolve(self):
        """Initial VC projection + a throwaway evolve for gradp at n-1/2."""
        self.in_preevolve = True
        myg = self.cc_data.grid

        for var in ("density", "x-velocity", "y-velocity"):
            self.cc_data.fill_BC(var)

        rho = self.cc_data.get_var("density").clone()
        u = self.cc_data.get_var("x-velocity").clone()
        v = self.cc_data.get_var("y-velocity").clone()
        beta0 = self.base["beta0"]

        coeff = (1.0 / rho) * self._t(beta0.full2d()) ** 2

        mg = self._vc_mg("phi", coeff)
        mg.init_RHS(self._cc_div_beta_U(u, v, beta0, mg.soln_grid))
        mg.solve(rtol=1.e-10)

        self.cc_data.set_var("phi", mg.get_solution(grid=myg))

        gradp_x, gradp_y = mg.get_solution_gradient(grid=myg)
        coeff_b = (1.0 / rho) * self._t(beta0.full2d())
        self.cc_data.set_var("x-velocity", u - coeff_b * gradp_x)
        self.cc_data.set_var("y-velocity", v - coeff_b * gradp_y)

        self.cc_data.fill_BC("x-velocity")
        self.cc_data.fill_BC("y-velocity")

        # evolve once for gradp at n-1/2, then restore the state (the clone
        # copies the state tensor, which evolve writes in place)
        orig_data = patch.cell_center_data_clone(self.cc_data)
        self.method_compute_timestep()
        self.evolve()

        orig_data.set_var("gradp_x", self.cc_data.get_var("gradp_x"))
        orig_data.set_var("gradp_y", self.cc_data.get_var("gradp_y"))
        self.cc_data = orig_data

        if self.verbose > 0:
            print("done with the pre-evolution")
        self.in_preevolve = False

    def evolve(self):
        """One low-Mach timestep: rho' advection + MAC and final VC
        projections."""
        myg = self.cc_data.grid
        dt = self.dt
        aux = self.aux_data

        # copies: the state tensor is written in place below
        rho = self.cc_data.get_var("density").clone()
        u = self.cc_data.get_var("x-velocity").clone()
        v = self.cc_data.get_var("y-velocity").clone()
        gradp_x = self.cc_data.get_var("gradp_x").clone()
        gradp_y = self.cc_data.get_var("gradp_y").clone()
        phi = self.cc_data.get_var("phi").clone()

        beta0 = self.base["beta0"]
        beta0_edges = self.base["beta0-edges"]
        rho0 = self.base["rho0"]
        beta0_2d = self._t(beta0.full2d())

        limiter = self.rp.get_param("lm-atmosphere.limiter")
        ldelta_rx = reconstruction.limit(rho, myg, 1, limiter)
        ldelta_ux = reconstruction.limit(u, myg, 1, limiter)
        ldelta_vx = reconstruction.limit(v, myg, 1, limiter)
        ldelta_ry = reconstruction.limit(rho, myg, 2, limiter)
        ldelta_uy = reconstruction.limit(u, myg, 2, limiter)
        ldelta_vy = reconstruction.limit(v, myg, 2, limiter)

        # --- MAC velocities ------------------------------------------------
        if self.verbose > 0:
            print("  making MAC velocities")

        coeff = self._set_filled(aux, "coeff", (1.0 / rho) * beta0_2d)

        g = self.rp.get_param("lm-atmosphere.grav")
        rhoprime = self.make_prime(rho, rho0)
        source = self._set_filled(aux, "source_y", rhoprime * g / rho)

        u_MAC, v_MAC = self.lm.mac_vels(
            dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy,
            coeff * gradp_x, coeff * gradp_y, source)

        # --- MAC projection ------------------------------------------------
        if self.verbose > 0:
            print("  MAC projection")

        coeff2 = (1.0 / rho) * beta0_2d ** 2
        mg = self._vc_mg("phi-MAC", coeff2)

        um = ai(u_MAC, myg)
        vm = ai(v_MAC, myg)
        div_v = (self._t(beta0.v2d()) * (um.ip(1) - um.v()) / myg.dx +
                 (self._t(beta0_edges.v2dp(1)) * vm.jp(1) -
                  self._t(beta0_edges.v2d()) * vm.v()) / myg.dy)
        div_beta_U = mg.soln_grid.scratch_array(dtype=self.dtype,
                                                device=self.device)
        div_beta_U[mg.ilo:mg.ihi + 1, mg.jlo:mg.jhi + 1] = div_v

        mg.init_RHS(div_beta_U)
        mg.solve(rtol=1.e-12)

        phi_MAC = mg.get_solution(grid=myg)
        self.cc_data.set_var("phi-MAC", phi_MAC)

        coeff = self._set_filled(aux, "coeff", (1.0 / rho) * beta0_2d)
        cv = ai(coeff, myg)
        pm = ai(phi_MAC, myg)

        bx = (0, 1, 0, 0)
        coeff_x = 0.5 * (cv.ip(-1, buf=bx) + cv.v(buf=bx))
        u_MAC[myg.ilo:myg.ihi + 2, myg.jlo:myg.jhi + 1] += \
            -coeff_x * (pm.v(buf=bx) - pm.ip(-1, buf=bx)) / myg.dx
        by = (0, 0, 0, 1)
        coeff_y = 0.5 * (cv.jp(-1, buf=by) + cv.v(buf=by))
        v_MAC[myg.ilo:myg.ihi + 1, myg.jlo:myg.jhi + 2] += \
            -coeff_y * (pm.v(buf=by) - pm.jp(-1, buf=by)) / myg.dy

        # --- advect rho' ----------------------------------------------------
        sl = (slice(myg.ilo, myg.ihi + 1), slice(myg.jlo, myg.jhi + 1))
        rho_old = rho
        rho = rho_old.clone()
        rho[sl] += self.lm.rho_increment(dt, rho_old, u_MAC, v_MAC,
                                         ldelta_rx, ldelta_ry)
        rho = self._set_filled(self.cc_data, "density", rho)

        # diagnostic internal energy
        gamma = self.rp.get_param("eos.gamma")
        p0_2d = self._t(self.base["p0"].full2d())
        self.cc_data.set_var("eint", p0_2d / (gamma - 1.0) / rho)

        # --- full interface states ------------------------------------------
        if self.verbose > 0:
            print("  making u, v edge states")

        coeff = self._set_filled(aux, "coeff",
                                 (2.0 / (rho + rho_old)) * beta0_2d)

        advect_x_v, advect_y_v = self.lm.advect_terms(
            dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy,
            coeff * gradp_x, coeff * gradp_y, source, u_MAC, v_MAC)

        # --- provisional velocity update ------------------------------------
        if self.verbose > 0:
            print("  doing provisional update of u, v")

        proj_type = self.rp.get_param("lm-atmosphere.proj_type")
        u = u.clone()
        v = v.clone()
        if proj_type == 1:
            u[sl] += -dt * (advect_x_v + ai(gradp_x, myg).v())
            v[sl] += -dt * (advect_y_v + ai(gradp_y, myg).v())
        elif proj_type == 2:
            u[sl] += -dt * advect_x_v
            v[sl] += -dt * advect_y_v

        # time-centered gravitational source
        rho_half = 0.5 * (rho + rho_old)
        rhoprime = self.make_prime(rho_half, rho0)
        source = self._set_filled(aux, "source_y", rhoprime * g / rho_half)
        v = v + dt * source

        u = self._set_filled(self.cc_data, "x-velocity", u)
        v = self._set_filled(self.cc_data, "y-velocity", v)

        if self.verbose > 0:
            print("min/max rho = {}, {}".format(
                self.cc_data.min("density"), self.cc_data.max("density")))

        # --- final projection -----------------------------------------------
        if self.verbose > 0:
            print("  final projection")

        coeff2 = (1.0 / rho) * beta0_2d ** 2
        mg = self._vc_mg("phi", coeff2)
        mg.init_RHS(self._cc_div_beta_U(u, v, beta0, mg.soln_grid) / dt)

        phiGuess = mg.soln_grid.scratch_array(dtype=self.dtype,
                                              device=self.device)
        phiGuess[mg.ilo - 1:mg.ihi + 2, mg.jlo - 1:mg.jhi + 2] = \
            ai(phi, myg).v(buf=1)
        mg.init_solution(phiGuess)
        mg.solve(rtol=1.e-12)

        phi = mg.get_solution(grid=myg)
        self.cc_data.set_var("phi", phi)

        gradphi_x, gradphi_y = mg.get_solution_gradient(grid=myg)

        coeff_b = (1.0 / rho) * beta0_2d
        u[sl] += -dt * ai(coeff_b * gradphi_x, myg).v()
        v[sl] += -dt * ai(coeff_b * gradphi_y, myg).v()

        if proj_type == 1:
            gradp_x[sl] += ai(gradphi_x, myg).v()
            gradp_y[sl] += ai(gradphi_y, myg).v()
        elif proj_type == 2:
            gradp_x[sl] = ai(gradphi_x, myg).v()
            gradp_y[sl] = ai(gradphi_y, myg).v()

        self.cc_data.set_var("x-velocity", u)
        self.cc_data.set_var("y-velocity", v)
        self.cc_data.set_var("gradp_x", gradp_x)
        self.cc_data.set_var("gradp_y", gradp_y)
        for var in ("x-velocity", "y-velocity", "gradp_x", "gradp_y"):
            self.cc_data.fill_BC(var)

        if not self.in_preevolve:
            self.cc_data.t += self.dt
            self.n += 1

    def dovis(self):
        """Runtime visualization: rho', U, vorticity."""
        from pyro2_tpu_torch.util import plot_tools

        myg = self.cc_data.grid
        rho = self.cc_data.get_var("density")
        u = self.cc_data.get_var("x-velocity")
        v = self.cc_data.get_var("y-velocity")
        rhoprime = self.make_prime(rho, self.base["rho0"])

        plot_tools.plot_fields(
            self, [(r"$\rho'$", rhoprime), ("x-velocity", u),
                   ("y-velocity", v),
                   ("vorticity", plot_tools.vorticity(u, v, myg))])

    def write_extras(self, f):
        """Store the base-state profiles."""
        gb = f.create_group("base state")
        for name, b in self.base.items():
            gb.create_dataset(name, data=b.d)

    def read_extras(self, f):
        """Restore the base-state profiles."""
        try:
            gb = f["base state"]
        except KeyError:
            return
        myg = self.cc_data.grid
        for name in gb:
            b = Basestate(myg.ny, ng=myg.ng)
            b.d[:] = gb[name][...]
            self.base[name] = b
