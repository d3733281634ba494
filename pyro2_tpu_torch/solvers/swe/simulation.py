"""Shallow water CTU Simulation.

The port of pyro2_tpu/solvers/swe/simulation.py.  Conserved order (height,
x-momentum, y-momentum, fuel[, hX...]); primitive order (h, u, v[, X...]).
The plain step (`Simulation._make_step`) runs the swe CTU pipeline as
tensor code: tracing -> first Riemann pass -> transverse corrections ->
second Riemann pass -> conservative update on the interior.  `evolve` goes
through the CUDA swe kernel's wrapper (swe_kernel.SWEStep), which launches
the kernel for CUDA tensors and runs the plain step for CPU tensors.  The
evolve is the step, so the on-device loop (driver_loop.run_sim_fast) runs
swe, its particles included, with SWEStep's device-dt entry.
"""

import torch

import pyro2_tpu_torch.mesh.boundary as bnd
import pyro2_tpu_torch.solvers.swe.unsplit_fluxes as flx
from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.simulation_null import (NullSimulation, bc_setup,
                                             grid_setup)
from pyro2_tpu_torch.solvers.swe import derives
from pyro2_tpu_torch.solvers.swe.swe_kernel import SWEStep
from pyro2_tpu_torch.util import profile_pyro

__all__ = ["Variables", "cons_to_prim", "prim_to_cons", "Simulation"]


class Variables:
    """Integer indices of the conserved and primitive SWE layouts."""

    def __init__(self, myd):
        self.nvar = len(myd.names)

        self.ih = myd.names.index("height")
        self.ixmom = myd.names.index("x-momentum")
        self.iymom = myd.names.index("y-momentum")

        self.naux = self.nvar - 3
        self.ihx = 3 if self.naux > 0 else -1

        # the conserved and primitive layouts share ih = 0
        self.nq = 3 + self.naux
        self.ih = 0
        self.iu = 1
        self.iv = 2
        self.ix = 3 if self.naux > 0 else -1


def cons_to_prim(U, ivars, myg):
    """(h, hu, hv[, hX]) -> (h, u, v[, X]), guarding h == 0 zones."""
    h = U[ivars.ih]
    nonzero = h != 0.0
    safe = torch.where(nonzero, h, 1.0)
    rows = [None] * ivars.nq
    rows[ivars.ih] = h
    rows[ivars.iu] = torch.where(nonzero, U[ivars.ixmom] / safe, 0.0)
    rows[ivars.iv] = torch.where(nonzero, U[ivars.iymom] / safe, 0.0)
    for nq_i, nu_i in zip(range(ivars.ix, ivars.ix + ivars.naux),
                          range(ivars.ihx, ivars.ihx + ivars.naux)):
        rows[nq_i] = torch.where(nonzero, U[nu_i] / safe, 0.0)
    return torch.stack(rows)


def prim_to_cons(q, ivars, myg):
    """(h, u, v[, X]) -> (h, hu, hv[, hX])."""
    rows = [None] * ivars.nvar
    rows[ivars.ih] = q[ivars.ih]
    rows[ivars.ixmom] = q[ivars.iu] * q[ivars.ih]
    rows[ivars.iymom] = q[ivars.iv] * q[ivars.ih]
    for nq_i, nu_i in zip(range(ivars.ix, ivars.ix + ivars.naux),
                          range(ivars.ihx, ivars.ihx + ivars.naux)):
        rows[nu_i] = q[nq_i] * q[ivars.ih]
    return torch.stack(rows)


class Simulation(NullSimulation):
    """The CTU shallow-water solver."""

    # evolve is _step (and the particle advance): the on-device loop
    # computes it (driver_loop.py)
    device_loop = True

    def initialize(self, *, extra_vars=None, ng=4):
        """Grid (ng=4), (height, momenta, fuel) variables, ICs, the step."""
        my_grid = grid_setup(self.rp, ng=ng)
        my_data = self.data_class(my_grid)

        bc, bc_xodd, bc_yodd = bc_setup(self.rp)
        self.solid = bnd.bc_is_solid(bc)

        my_data.register_var("height", bc)
        my_data.register_var("x-momentum", bc_xodd)
        my_data.register_var("y-momentum", bc_yodd)
        my_data.register_var("fuel", bc)
        if extra_vars is not None:
            for v in extra_vars:
                my_data.register_var(v, bc)

        my_data.set_aux("g", self.rp.get_param("swe.grav"))
        my_data.create()
        self.cc_data = my_data
        self.init_particles(bc)

        aux_data = self.data_class(my_grid)
        aux_data.register_var("ymom_src", bc_yodd)
        aux_data.create()
        self.aux_data = aux_data

        self.ivars = Variables(my_data)
        self.cc_data.add_ivars(self.ivars)
        self.cc_data.add_derived(derives.derive_primitives)

        self.problem_func(self.cc_data, self.rp)

        if self.verbose > 0:
            print(my_data)

        # no fallback: CUDA tensors launch the kernel or raise
        self._step = SWEStep(self)
        self._dt_fn = self._make_dt()

    def _make_dt(self):
        myg = self.cc_data.grid
        ivars = self.ivars
        grav = self.rp.get_param("swe.grav")

        def dt_fn(U):
            # the CFL minimum over the interior only
            q = cons_to_prim(U, ivars, myg)
            cs = torch.sqrt(grav * q[ivars.ih])
            xtmp = ai(myg.dx / (q[ivars.iu].abs() + cs), myg).v()
            ytmp = ai(myg.dy / (q[ivars.iv].abs() + cs), myg).v()
            return torch.minimum(xtmp.min(), ytmp.min())

        return dt_fn

    def _make_step(self):
        """The plain tensor swe step(U, t, dt) -> U_new (the CPU oracle of
        the CUDA kernel; U is not modified).  The interior is updated and
        the ghosts are carried through stale: fill_BC_all refills them
        before the next step."""
        myg = self.cc_data.grid
        rp = self.rp
        ivars = self.ivars
        solid = self.solid
        tc = self.tc
        my_data = self.cc_data

        iv_sl = (slice(None), slice(myg.ilo, myg.ihi + 1),
                 slice(myg.jlo, myg.jhi + 1))

        def step(U, t, dt):
            # t is unused (no time-dependent sources in SWE) but kept so
            # every solver's step shares the (U, t, dt) contract
            del t
            F_x, F_y = flx.unsplit_fluxes(U, my_data, rp, ivars, solid,
                                          tc, dt)
            dtdx = dt / myg.dx
            dtdy = dt / myg.dy
            Fx = ai(F_x, myg)
            Fy = ai(F_y, myg)
            upd = (dtdx * (Fx.v() - Fx.ip(1)) +
                   dtdy * (Fy.v() - Fy.jp(1)))
            U = U.clone()
            U[iv_sl] += upd
            return U

        return step

    def method_compute_timestep(self):
        """CFL: dt = cfl * min(dx/(|u|+cs), dy/(|v|+cs))."""
        cfl = self.rp.get_param("driver.cfl")
        self.dt = cfl * profile_pyro.read(
            self._dt_fn(self.cc_data.data), "dt")

    def evolve(self):
        """One swe CTU step (one kernel launch on CUDA)."""
        U = self._step(self.cc_data.data, self.cc_data.t, self.dt)
        self.cc_data.set_vars(U)

        if self.particles is not None:
            self.particles.update_particles(self.dt,
                                            *self.particle_velocity(U))

        self.cc_data.t += self.dt
        self.n += 1

    def particle_velocity(self, U):
        """(u, v) of a stack: the momenta over the height, the derived
        "velocity" (derives.derive_primitives) the particles advance with
        (no host read)."""
        iv = self.ivars
        return U[iv.ixmom] / U[iv.ih], U[iv.iymom] / U[iv.ih]

    def dovis(self):
        """Runtime visualization: h, |U|, vorticity, fuel fraction."""
        from pyro2_tpu_torch.util import plot_tools

        ivars = Variables(self.cc_data)
        myg = self.cc_data.grid
        q = cons_to_prim(self.cc_data.data, ivars, myg)

        h = q[ivars.ih]
        u = q[ivars.iu]
        v = q[ivars.iv]
        magvel = torch.sqrt(u ** 2 + v ** 2)

        fields = [("h", h), ("U", magvel),
                  ("vorticity", plot_tools.vorticity(u, v, myg))]
        if ivars.naux > 0:
            fields.append(("X", q[ivars.ix]))
        plot_tools.plot_fields(self, fields)
