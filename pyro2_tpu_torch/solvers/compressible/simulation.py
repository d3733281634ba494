"""Compressible Euler CTU Simulation.

The port of pyro2_tpu/solvers/compressible/simulation.py, Cartesian and
spherical geometry.  The plain step (`plain_step`, which
`Simulation._make_step` builds) runs the CTU pipeline as tensor code:
density floor -> tracing -> sources -> transverse -> Riemann -> artificial
viscosity -> conservative update -> (spherical pressure gradients) ->
predictor-corrector sources -> sponge.  `evolve` goes through the CUDA CTU
kernel's wrapper (ctu_kernel.CTUStep), which launches the kernel for CUDA
tensors and runs the plain step for CPU tensors.

Stacks are (nvar, qx, qy); conserved order (density, energy, x-momentum,
y-momentum[, rho X...]) as registered, primitive order (rho, u, v, p[,
X...]).
"""

import math

import torch

import pyro2_tpu_torch.mesh.boundary as bnd
import pyro2_tpu_torch.solvers.compressible.unsplit_fluxes as flx
from pyro2_tpu_torch.mesh.indexer import ai, aic
from pyro2_tpu_torch.simulation_null import (NullSimulation, bc_setup,
                                             grid_setup)
from pyro2_tpu_torch.solvers.compressible import BC, derives, eos, riemann
from pyro2_tpu_torch.util import msg, profile_pyro

__all__ = ["Variables", "DomainEdges", "cons_to_prim", "prim_to_cons",
           "get_external_sources", "get_sponge_factor", "energy_source",
           "weight_plane", "energy_rate", "plain_step", "Simulation"]


class Variables:
    """Integer indices of the conserved and primitive variable layouts."""

    def __init__(self, myd):
        self.nvar = len(myd.names)

        self.idens = myd.names.index("density")
        self.ixmom = myd.names.index("x-momentum")
        self.iymom = myd.names.index("y-momentum")
        self.iener = myd.names.index("energy")

        # any additional variables are passively advected scalars
        self.naux = self.nvar - 4
        self.irhox = 4 if self.naux > 0 else -1

        self.nq = 4 + self.naux
        self.irho = 0
        self.iu = 1
        self.iv = 2
        self.ip = 3
        self.ix = 4 if self.naux > 0 else -1


class DomainEdges:
    """Domain-edge flags (xl, xr, yl, yr): 1 where this grid's edge is the
    physical domain's boundary.  All 1 on a serial grid; a block of a
    sharded run (parallel/sharded.py) has 0 where its edge is a seam, so
    the artificial viscosity follows the global domain's window."""

    def __init__(self, xl=1, xr=1, yl=1, yr=1):
        self.xl, self.xr, self.yl, self.yr = xl, xr, yl, yr

    def flags(self):
        return (self.xl, self.xr, self.yl, self.yr)


def cons_to_prim(U, gamma, ivars, myg, *, check=True):
    """Conserved stack -> primitive stack (guarding rho == 0 zones).

    `check` runs the host-side state-validity check (min rho and min e on
    the interior must be positive), which reads values back from the
    device.  The JAX package runs it only outside jit, i.e. in host-side
    calls; the step and the CFL timestep pass check=False, as their jitted
    JAX twins skip it."""
    rho = U[ivars.idens]
    nonzero = rho != 0.0
    safe_rho = torch.where(nonzero, rho, 1.0)

    u = torch.where(nonzero, U[ivars.ixmom] / safe_rho, 0.0)
    v = torch.where(nonzero, U[ivars.iymom] / safe_rho, 0.0)
    e = torch.where(nonzero,
                    (U[ivars.iener] - 0.5 * rho * (u ** 2 + v ** 2)) /
                    safe_rho, 0.0)

    if check:
        e_min = float(ai(e, myg).v().min())
        rho_min = float(ai(rho, myg).v().min())
        if not (e_min > 0.0 and rho_min > 0.0):
            raise ValueError(
                f"invalid state, min(rho) = {rho_min}, min(e) = {e_min}")

    rows = [None] * ivars.nq
    rows[ivars.irho] = rho
    rows[ivars.iu] = u
    rows[ivars.iv] = v
    rows[ivars.ip] = eos.pres(gamma, rho, e)
    for nq_i, nu_i in zip(range(ivars.ix, ivars.ix + ivars.naux),
                          range(ivars.irhox, ivars.irhox + ivars.naux)):
        rows[nq_i] = torch.where(nonzero, U[nu_i] / safe_rho, 0.0)
    return torch.stack(rows)


def prim_to_cons(q, gamma, ivars, myg):
    """Primitive stack -> conserved stack."""
    rows = [None] * ivars.nvar
    rows[ivars.idens] = q[ivars.irho]
    rows[ivars.ixmom] = q[ivars.iu] * q[ivars.irho]
    rows[ivars.iymom] = q[ivars.iv] * q[ivars.irho]
    rhoe = eos.rhoe(gamma, q[ivars.ip])
    rows[ivars.iener] = rhoe + 0.5 * q[ivars.irho] * \
        (q[ivars.iu] ** 2 + q[ivars.iv] ** 2)
    for nq_i, nu_i in zip(range(ivars.ix, ivars.ix + ivars.naux),
                          range(ivars.irhox, ivars.irhox + ivars.naux)):
        rows[nu_i] = q[nq_i] * q[ivars.irho]
    return torch.stack(rows)


def weight_plane(myg, rp, source_weight, like):
    """(e_rate, w) of a problem's source_weight(myg, rp), with the float64
    weight plane w rounded once to a tensor of `like`'s dtype on its
    device.  Both are made once per grid, function, dtype and device: a
    per-step copy from pageable host memory would stall the host."""
    key = (source_weight, like.dtype, like.device)
    cache = myg.__dict__.setdefault("_source_weights", {})
    if key not in cache:
        e_rate, w = source_weight(myg, rp)
        cache[key] = (e_rate, torch.as_tensor(w, dtype=like.dtype,
                                              device=like.device))
    return cache[key]


def energy_rate(sim, like):
    """(e_rate, w) of sim's problem source as the CUDA kernels take it, w
    in `like`'s dtype on its device (weight_plane), or (0.0, None) with no
    problem source.  The kernels take a problem source that is the energy
    rate rho e_rate w(x, y), given by the problem's source_weight; any
    other raises NotImplementedError."""
    if sim.problem_source is None:
        return 0.0, None
    if sim.problem_source_weight is None:
        raise NotImplementedError(
            "a problem source other than the energy rate rho e_rate w(x, y) "
            "waits for a later slice of the port (ROADMAP.md A.27)")
    return weight_plane(sim.cc_data.grid, sim.rp, sim.problem_source_weight,
                        like)


def energy_source(myg, U, ivars, rp, source_weight):
    """The source stack of a problem whose one source is the energy rate
    rho * e_rate * w(x, y), source_weight(myg, rp) -> (e_rate, w): zero
    but for the energy row, (rho * e_rate) * w."""
    e_rate, w = weight_plane(myg, rp, source_weight, U)
    S = torch.zeros_like(U)
    S[ivars.iener] = U[ivars.idens] * e_rate * w
    return S


def get_external_sources(t, dt, U, ivars, rp, myg, *,
                         U_old=None, problem_source=None):
    """External sources: gravity in y (Cartesian geometry), or radial
    gravity plus the geometric momentum terms ymom^2 / (rho r) and
    -xmom ymom / rho (spherical geometry, present even with grav = 0),
    plus the problem's own source terms of U.  With U_old (U ~ U^{n+1}
    including a full dt*S_old) the energy source is time-centred with the
    corrected momentum."""
    grav = rp.get_param("compressible.grav")

    zero = torch.zeros_like(U[0])
    rows = [zero] * ivars.nvar
    if getattr(myg, "coord_type", 0) == 1:
        x2d = myg.tensor("x2d", U)
        if U_old is None:
            S_xmom = U[ivars.idens] * grav
            rows[ivars.iener] = U[ivars.ixmom] * grav
        else:
            S_xmom = U[ivars.idens] * grav
            S_old_xmom = U_old[ivars.idens] * grav
            xmom_new = U[ivars.ixmom] + 0.5 * dt * (S_xmom - S_old_xmom)
            rows[ivars.iener] = xmom_new * grav
        rows[ivars.ixmom] = S_xmom + U[ivars.iymom] ** 2 / (
            U[ivars.idens] * x2d)
        rows[ivars.iymom] = zero - U[ivars.ixmom] * U[ivars.iymom] / \
            U[ivars.idens]
    elif U_old is None:
        rows[ivars.iymom] = U[ivars.idens] * grav
        rows[ivars.iener] = U[ivars.iymom] * grav
    else:
        S_ymom = U[ivars.idens] * grav
        S_old_ymom = U_old[ivars.idens] * grav
        ymom_new = U[ivars.iymom] + 0.5 * dt * (S_ymom - S_old_ymom)
        rows[ivars.iymom] = S_ymom
        rows[ivars.iener] = ymom_new * grav
    S = torch.stack(rows)
    if problem_source:
        S = S + problem_source(myg, U, ivars, rp)
    return S


def get_sponge_factor(U, ivars, rp, myg):
    """The sponge damping rate f/tau."""
    rho = U[ivars.idens]
    rho_begin = rp.get_param("sponge.sponge_rho_begin")
    rho_full = rp.get_param("sponge.sponge_rho_full")
    if not rho_begin > rho_full:
        raise ValueError("sponge_rho_begin must exceed sponge_rho_full")

    f = torch.where(rho > rho_begin, 0.0,
                    torch.where(rho < rho_full, 1.0,
                                0.5 * (1.0 - torch.cos(
                                    math.pi * (rho - rho_begin) /
                                    (rho_full - rho_begin)))))
    tau = rp.get_param("sponge.sponge_timescale")
    return f / tau


def plain_step(my_data, rp, ivars, solid, tc, *, aux=None, small_dens=None,
               sponge=False, problem_source=None, edges=(1, 1, 1, 1)):
    """The plain tensor CTU step(U, t, dt) -> U_new on my_data.grid: density
    floor -> tracing -> half-dt sources -> transverse -> Riemann ->
    artificial viscosity -> conservative update -> (spherical pressure
    gradients) -> predictor-corrector sources -> sponge.  U is not
    modified, and its ghosts are carried into U_new.

    aux is the source container whose BCs fill the half-dt source stack:
    None leaves the external sources out altogether, small_dens None the
    floor, sponge False the sponge (the padded entries' step, which has
    none of them; padded_step.py).  problem_source(myg, U, ivars, rp) is
    the problem's own source, added to the external sources.  edges are
    the domain-edge flags (DomainEdges.flags) of the artificial
    viscosity."""
    myg = my_data.grid
    gamma = rp.get_param("eos.gamma")
    spherical = getattr(myg, "coord_type", 0) == 1

    iv_sl = (slice(myg.ilo, myg.ihi + 1), slice(myg.jlo, myg.jhi + 1))
    all_iv = (slice(None),) + iv_sl

    def step(U, t, dt):
        U = U.clone()
        if small_dens is not None:
            # density floor (clean_state) on the global interior.  The
            # default sentinel (-1e200) is out of f32 range: clamp it to
            # the dtype's finfo min, which keeps the floor a no-op
            floor = max(small_dens, torch.finfo(U.dtype).min)
            U[(ivars.idens,) + iv_sl] = \
                U[(ivars.idens,) + iv_sl].clamp_min(floor)

        U_xl, U_xr, U_yl, U_yr = flx.interface_states(
            U, my_data, rp, ivars, tc, dt)

        if aux is not None:
            U_xl, U_xr, U_yl, U_yr = flx.apply_source_terms(
                U_xl, U_xr, U_yl, U_yr, U, t, my_data, aux, rp, ivars, tc,
                dt, problem_source=problem_source)

        U_xl, U_xr, U_yl, U_yr = flx.apply_transverse_flux(
            U_xl, U_xr, U_yl, U_yr, my_data, rp, ivars, solid, tc, dt)

        if spherical:
            F_x, U_x = riemann.riemann_flux(1, U_xl, U_xr, my_data, rp,
                                            ivars, solid.xl, solid.xr, tc,
                                            return_cons=True)
            F_y, U_y = riemann.riemann_flux(2, U_yl, U_yr, my_data, rp,
                                            ivars, solid.yl, solid.yr, tc,
                                            return_cons=True)
        else:
            F_x = riemann.riemann_flux(1, U_xl, U_xr, my_data, rp,
                                       ivars, solid.xl, solid.xr, tc)
            F_y = riemann.riemann_flux(2, U_yl, U_yr, my_data, rp,
                                       ivars, solid.yl, solid.yr, tc)

        q = cons_to_prim(U, gamma, ivars, myg, check=False)
        F_x, F_y = flx.apply_artificial_viscosity(
            F_x, F_y, q, U, my_data, rp, ivars, edges=edges)

        U_old = U

        # conservative update, weighted by the face areas and cell volumes
        if spherical:
            dtdV = dt / ai(myg.tensor("V", U), myg).v()
            Ax = ai(myg.tensor("Ax", U), myg)
            Ay = ai(myg.tensor("Ay", U), myg)
        else:
            dtdV = dt / (myg.dx * myg.dy)
            Ax = aic(myg.dy)
            Ay = aic(myg.dx)
        Fx = ai(F_x, myg)
        Fy = ai(F_y, myg)
        upd = dtdV * (
            Fx.v() * Ax.v() - Fx.ip(1) * Ax.ip(1) +
            Fy.v() * Ay.v() - Fy.jp(1) * Ay.jp(1))
        U = U_old.clone()
        U[all_iv] += upd

        if spherical:
            # non-conservative pressure gradients (momenta) from the
            # final pair's CGF interface states
            px = ai(cons_to_prim(U_x, gamma, ivars, myg,
                                 check=False)[ivars.ip], myg)
            py = ai(cons_to_prim(U_y, gamma, ivars, myg,
                                 check=False)[ivars.ip], myg)
            U[(ivars.ixmom,) + iv_sl] += \
                -dt * (px.ip(1) - px.v()) / ai(myg.tensor("Lx", U), myg).v()
            U[(ivars.iymom,) + iv_sl] += \
                -dt * (py.jp(1) - py.v()) / ai(myg.tensor("Ly", U), myg).v()

        if aux is not None:
            # predictor-corrector external sources
            S_old = get_external_sources(t, dt, U_old, ivars, rp, myg,
                                         problem_source=problem_source)
            U[all_iv] += dt * S_old[all_iv]

            S_new = get_external_sources(t, dt, U, ivars, rp, myg,
                                         U_old=U_old,
                                         problem_source=problem_source)
            U[all_iv] += 0.5 * dt * (S_new - S_old)[all_iv]

        # implicit sponge damping of the velocity (whole array)
        if sponge:
            kappa_f = get_sponge_factor(U, ivars, rp, myg)
            damp = 1.0 + dt * kappa_f
            pre_x = U[ivars.ixmom].clone()
            pre_y = U[ivars.iymom].clone()
            U[ivars.ixmom] = pre_x / damp
            U[ivars.iymom] = pre_y / damp
            dke = 0.5 * ((U[ivars.ixmom] ** 2 + U[ivars.iymom] ** 2) -
                         (pre_x ** 2 + pre_y ** 2)) / U[ivars.idens]
            U[ivars.iener] += dke

        return U

    return step


class Simulation(NullSimulation):
    """The CTU compressible hydrodynamics solver."""

    # the stage increment kind of the method-of-lines solvers (None: the
    # CTU step)
    MOL_KIND = None

    # evolve is fill -> _step -> particle advance, the on-device loop's body
    device_loop = True

    def initialize(self, *, extra_vars=None, ng=4):
        """Grid (ng=4), the 4 conserved vars (+extras), aux source-term
        container, custom BCs, ICs, and the step."""
        my_grid = grid_setup(self.rp, ng=ng)
        if getattr(my_grid, "coord_type", 0) == 1:
            riemann_method = self.rp.get_param("compressible.riemann")
            if riemann_method == "HLLC":
                msg.fail("ERROR: HLLC Riemann Solver is not supported "
                         "with SphericalPolar Geometry")
            if riemann_method != "CGF" and self.MOL_KIND is None:
                # the spherical CTU step reads the Riemann solver's
                # interface state, which only CGF returns (the JAX
                # package's step fails unpacking HLLC_lm's flux); the
                # method-of-lines stages read the flux alone
                raise ValueError(
                    f"the {riemann_method} Riemann solver has no interface "
                    "state: the SphericalPolar CTU step needs "
                    "compressible.riemann = CGF")
        my_data = self.data_class(my_grid)

        bnd.define_bc("hse", BC.user, is_solid=False)
        bnd.define_bc("ambient", BC.user, is_solid=False)
        bnd.define_bc("ramp", BC.user, is_solid=False)

        bc, bc_xodd, bc_yodd = bc_setup(self.rp)
        self.solid = bnd.bc_is_solid(bc)
        self.domain_edges = DomainEdges()

        my_data.register_var("density", bc)
        my_data.register_var("energy", bc)
        my_data.register_var("x-momentum", bc_xodd)
        my_data.register_var("y-momentum", bc_yodd)
        if extra_vars is not None:
            for v in extra_vars:
                my_data.register_var(v, bc)

        my_data.set_aux("gamma", self.rp.get_param("eos.gamma"))
        my_data.set_aux("grav", self.rp.get_param("compressible.grav"))

        my_data.create()
        self.cc_data = my_data
        self.init_particles(bc)

        # source terms needing their own ghost fill
        aux_data = self.data_class(my_grid)
        aux_data.register_var("dens_src", bc)
        aux_data.register_var("xmom_src", bc_xodd)
        aux_data.register_var("ymom_src", bc_yodd)
        aux_data.register_var("E_src", bc)
        aux_data.create()
        aux_data.aux = my_data.aux
        self.aux_data = aux_data

        self.ivars = Variables(my_data)
        self.cc_data.add_ivars(self.ivars)
        self.cc_data.add_derived(derives.derive_primitives)

        self.problem_func(self.cc_data, self.rp)

        if self.verbose > 0:
            print(my_data)

        # no fallback: CUDA tensors launch the kernel or raise
        self._step = self._make_kernel_step()
        self._dt_fn = self._make_dt()

    def _make_kernel_step(self):
        """The kernel-backed callable that `evolve` runs: the CTU step.
        The method-of-lines solvers override it with their stage
        increment, so they never build (or launch) the CTU kernel."""
        from pyro2_tpu_torch.solvers.compressible.ctu_kernel import CTUStep
        return CTUStep(self)

    # -- the plain step and timestep -----------------------------------------
    def _make_dt(self):
        myg = self.cc_data.grid
        gamma = self.rp.get_param("eos.gamma")
        ivars = self.ivars
        spherical = getattr(myg, "coord_type", 0) == 1

        def dt_fn(U):
            q = cons_to_prim(U, gamma, ivars, myg, check=False)
            cs = torch.sqrt(gamma * q[ivars.ip] / q[ivars.irho])
            if spherical:
                Lx, Ly = myg.tensor("Lx", U), myg.tensor("Ly", U)
            else:
                Lx, Ly = myg.dx, myg.dy
            xtmp = ai(Lx / (q[ivars.iu].abs() + cs), myg).v()
            ytmp = ai(Ly / (q[ivars.iv].abs() + cs), myg).v()
            return torch.minimum(xtmp.min(), ytmp.min())

        return dt_fn

    def _make_step(self):
        """The plain tensor CTU step(U, t, dt) -> U_new (the CPU oracle
        of the CUDA kernel; U is not modified)."""
        rp = self.rp
        return plain_step(self.cc_data, rp, self.ivars, self.solid, self.tc,
                          aux=self.aux_data,
                          small_dens=rp.get_param("compressible.small_dens"),
                          sponge=bool(rp.get_param("sponge.do_sponge")),
                          problem_source=self.problem_source,
                          edges=self.domain_edges.flags())

    # -- host-side driver hooks --------------------------------------------
    def method_compute_timestep(self):
        """CFL: dt = cfl * min(Lx/(|u|+cs), Ly/(|v|+cs))."""
        cfl = self.rp.get_param("driver.cfl")
        self.dt = cfl * profile_pyro.read(
            self._dt_fn(self.cc_data.data), "dt")

    def evolve(self):
        """One CTU step (one kernel launch on CUDA)."""
        U = self._step(self.cc_data.data, self.cc_data.t, self.dt)
        self.cc_data.set_vars(U)

        if self.particles is not None:
            self.particles.update_particles(self.dt,
                                            *self.particle_velocity(U))

        self.cc_data.t += self.dt
        self.n += 1

    def particle_velocity(self, U):
        """(u, v) of a stack: the momenta over the density, the derived
        velocity the particles advance with (no host read)."""
        iv = self.ivars
        return U[iv.ixmom] / U[iv.idens], U[iv.iymom] / U[iv.idens]

    def clean_state(self, U):
        """Enforce the density floor on a stack (returns a new tensor)."""
        small_dens = self.rp.get_param("compressible.small_dens")
        g = self.cc_data.grid
        sl = (self.ivars.idens, slice(g.ilo, g.ihi + 1),
              slice(g.jlo, g.jhi + 1))
        floor = max(small_dens, torch.finfo(U.dtype).min)
        U = U.clone()
        U[sl] = U[sl].clamp_min(floor)
        return U

    def dovis(self):
        """Runtime visualization: rho, |U|, p, e (on a spherical grid the
        r-theta cells projected to x-z)."""
        import matplotlib.pyplot as plt
        import numpy as np

        from pyro2_tpu_torch.util import plot_tools

        ivars = Variables(self.cc_data)
        gamma = self.cc_data.get_aux("gamma")
        myg = self.cc_data.grid
        q = cons_to_prim(self.cc_data.data, gamma, ivars, myg)

        rho = q[ivars.irho]
        u = q[ivars.iu]
        v = q[ivars.iv]
        p = q[ivars.ip]
        e = eos.rhoe(gamma, p) / rho
        magvel = torch.sqrt(u ** 2 + v ** 2)

        fields = [(r"$\rho$", rho), ("U", magvel), ("p", p), ("e", e)]

        if getattr(myg, "coord_type", 0) == 1:
            # project the r-theta grid to x-z for plotting
            plt.clf()
            x = np.asarray(myg.x2d) * np.sin(np.asarray(myg.y2d))
            y = np.asarray(myg.x2d) * np.cos(np.asarray(myg.y2d))
            _, axes, _ = plot_tools.setup_axes(myg, len(fields))
            values = plot_tools.host_interiors(myg, [f for _, f in fields])
            xv = x[myg.ilo:myg.ihi + 1, myg.jlo:myg.jhi + 1]
            yv = y[myg.ilo:myg.ihi + 1, myg.jlo:myg.jhi + 1]
            for n, (name, _) in enumerate(fields):
                ax = axes[n]
                img = ax.pcolormesh(xv, yv, values[n], shading="nearest",
                                    cmap=self.cm)
                axes.cbar_axes[n].colorbar(img)
                ax.set_title(name)
            plt.figtext(0.05, 0.0125, f"t = {self.cc_data.t:10.5g}")
            plt.pause(0.001)
            plt.draw()
        else:
            plot_tools.plot_fields(self, fields)

    def write_extras(self, f):
        """Record the custom-BC names (restart support)."""
        gb = f.create_group("BC")
        gb.create_dataset("hse", data=False)
        gb.create_dataset("ambient", data=False)
