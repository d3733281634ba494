"""The base Simulation contract and time-loop helpers.

The port of pyro2_tpu/simulation_null.py: solvers subclass NullSimulation
and implement initialize / method_compute_timestep / evolve / preevolve.
The numeric work inside those methods is tensor code on the simulation's
device; this layer is the host-side time loop and bookkeeping.
"""

import numpy as np

import pyro2_tpu_torch.mesh.boundary as bnd
import pyro2_tpu_torch.util.profile_pyro as profile
from pyro2_tpu_torch.defaults import dtype as _working_dtype
from pyro2_tpu_torch.defaults import resolve_device
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Cartesian2d, SphericalPolar
from pyro2_tpu_torch.util import hdf5, msg

__all__ = ["NullSimulation", "grid_setup", "bc_setup"]


def grid_setup(rp, ng=1):
    """Build the grid named by the mesh.* runtime parameters."""
    nx = rp.get_param("mesh.nx")
    ny = rp.get_param("mesh.ny")

    def opt(name, default):
        try:
            return rp.get_param(name)
        except KeyError:
            msg.warning(f"{name} not set, defaulting to {default}")
            return default

    xmin = opt("mesh.xmin", 0.0)
    xmax = opt("mesh.xmax", 1.0)
    ymin = opt("mesh.ymin", 0.0)
    ymax = opt("mesh.ymax", 1.0)
    grid_type = opt("mesh.grid_type", "Cartesian2d")

    if grid_type == "Cartesian2d":
        create_grid = Cartesian2d
    elif grid_type == "SphericalPolar":
        create_grid = SphericalPolar
    else:
        raise ValueError("Unsupported grid type!")

    my_grid = create_grid(nx, ny, xmin=xmin, xmax=xmax,
                          ymin=ymin, ymax=ymax, ng=ng)

    # spherical: force reflecting theta boundaries at the poles
    if grid_type == "SphericalPolar":
        if ymin <= 0.05:
            rp.set_param("mesh.ylboundary", "reflect")
            msg.warning("With SphericalPolar grid, mesh.ylboundary auto set "
                        "to reflect when ymin ~ 0")
        if abs(np.pi - ymax) <= 0.05:
            rp.set_param("mesh.yrboundary", "reflect")
            msg.warning("With SphericalPolar grid, mesh.yrboundary auto set "
                        "to reflect when ymax ~ pi")

    return my_grid


def bc_setup(rp):
    """The (even, x-odd, y-odd) BC triple named by mesh.*boundary params."""
    def opt(name):
        try:
            return rp.get_param(name)
        except KeyError:
            msg.warning(f"{name} is not set, defaulting to periodic")
            return "periodic"

    xlb_type = opt("mesh.xlboundary")
    xrb_type = opt("mesh.xrboundary")
    ylb_type = opt("mesh.ylboundary")
    yrb_type = opt("mesh.yrboundary")

    bc = bnd.BC(xlb=xlb_type, xrb=xrb_type, ylb=ylb_type, yrb=yrb_type)
    bc_xodd = bnd.BC(xlb=xlb_type, xrb=xrb_type, ylb=ylb_type, yrb=yrb_type,
                     odd_reflect_dir="x")
    bc_yodd = bnd.BC(xlb=xlb_type, xrb=xrb_type, ylb=ylb_type, yrb=yrb_type,
                     odd_reflect_dir="y")
    return bc, bc_xodd, bc_yodd


class NullSimulation:
    """Base class: the solver contract plus generic time-loop helpers.

    `device` defaults to CUDA (raising when there is none); `dtype`
    defaults to the device's working dtype (see pyro2_tpu_torch.defaults).
    """

    # does driver_loop.run_sim_fast compute what evolve does?  (True where
    # evolve is one fill -> dt -> step, then the particle advance)
    device_loop = False

    def __init__(self, solver_name, problem_name, problem_func, rp, *,
                 problem_finalize_func=None, problem_source_func=None,
                 problem_source_weight_func=None, timers=None, device=None,
                 dtype=None):
        self.n = 0
        self.dt = -1.e33
        self.dt_old = -1.e33

        self.device = resolve_device(device)
        self.dtype = _working_dtype(self.device, dtype)

        try:
            self.tmax = rp.get_param("driver.tmax")
        except (AttributeError, KeyError):
            self.tmax = None
        try:
            self.max_steps = rp.get_param("driver.max_steps")
        except (AttributeError, KeyError):
            self.max_steps = None

        self.rp = rp
        self.cc_data = None
        self.particles = None

        self.SMALL = 1.e-12

        self.solver_name = solver_name
        self.problem_name = problem_name
        self.problem_func = problem_func
        self.problem_finalize = problem_finalize_func
        self.problem_source = problem_source_func
        # (e_rate, w) of a source_terms that is the energy rate
        # rho e_rate w(x, y): what the compressible kernels take of it
        self.problem_source_weight = problem_source_weight_func

        self.tc = timers if timers is not None else profile.TimerCollection()

        try:
            self.verbose = self.rp.get_param("driver.verbose")
        except (AttributeError, KeyError):
            self.verbose = 0

        self.n_num_out = 0
        # the colormap of dovis
        self.cm = "viridis"

    def init_particles(self, bc):
        """Build the tracer particles on cc_data when
        particles.do_particles is 1 (the generator and count from
        particles.*)."""
        if self.rp.get_param("particles.do_particles") == 1:
            from pyro2_tpu_torch.particles import Particles
            self.particles = Particles(
                self.cc_data, bc, self.rp.get_param("particles.n_particles"),
                self.rp.get_param("particles.particle_generator"))

    def data_class(self, grid):
        """A cell-centered container on this simulation's device/dtype."""
        return patch.CellCenterData2d(grid, dtype=self.dtype,
                                      device=self.device)

    def __str__(self):
        return (f"pyro Simulation:\n  solver: {self.solver_name}\n"
                f"  problem: {self.problem_name}\n")

    def finished(self):
        """Has the simulation hit tmax or max_steps?"""
        return self.cc_data.t >= self.tmax or self.n >= self.max_steps

    def do_output(self):
        """Is it time to write an output file?"""
        dt_out = self.rp.get_param("io.dt_out")
        n_out = self.rp.get_param("io.n_out")
        do_io = self.rp.get_param("io.do_io")

        is_time = (self.cc_data.t >= (self.n_num_out + 1) * dt_out or
                   self.n % n_out == 0)
        if is_time and do_io == 1:
            self.n_num_out += 1
            return True
        return False

    def initialize(self):
        pass

    def method_compute_timestep(self):
        """The method-specific timestep computation (sets self.dt)."""

    def compute_timestep(self):
        """Generic timestep wrapper respecting the driver.* parameters."""
        init_tstep_factor = self.rp.get_param("driver.init_tstep_factor")
        max_dt_change = self.rp.get_param("driver.max_dt_change")
        fix_dt = self.rp.get_param("driver.fix_dt")

        if fix_dt > 0.0:
            self.dt = fix_dt
        else:
            self.method_compute_timestep()
            if self.n == 0:
                self.dt = init_tstep_factor * self.dt
            else:
                self.dt = min(max_dt_change * self.dt_old, self.dt)
            self.dt_old = self.dt

        if self.cc_data.t + self.dt > self.tmax:
            self.dt = self.tmax - self.cc_data.t

    def preevolve(self):
        """Any evolution needed before the main loop (default: none)."""

    def evolve(self):
        self.cc_data.t += self.dt
        self.n += 1

    def dovis(self):
        pass

    def finalize(self):
        """Final cleanups; calls the problem's finalize()."""
        if self.problem_finalize:
            self.problem_finalize()

    def write(self, filename):
        """Write the full simulation state to HDF5 (util/hdf5.py)."""
        if not filename.endswith(".h5"):
            filename += ".h5"

        with hdf5.File(filename, "w") as f:
            f.attrs["solver"] = self.solver_name
            f.attrs["problem"] = self.problem_name
            f.attrs["time"] = self.cc_data.t
            f.attrs["nsteps"] = self.n

            self.cc_data.write_data(f)
            if self.particles is not None:
                self.particles.write_particles(f)
            self.rp.write_params(f)
            self.write_extras(f)

    def write_extras(self, f):
        """Write any solver-specific extras (subclass hook)."""

    def read_extras(self, f):
        """Read any solver-specific extras (subclass hook)."""
