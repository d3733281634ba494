"""HDF5 checkpoint reading: rebuild a simulation from an output file.

The port of pyro2_tpu/util/io_pyro.py.  Any output doubles as the
regression-comparison format: `read` re-registers the custom BCs from the
port's own solver BC modules, rebuilds the grid (Cartesian2d or
SphericalPolar from coord_type), the state and its aux data on the given
device and dtype, and a Simulation built without runtime parameters (it
holds the state, n, t, the particles, the solver's extras and the derived
variables, and cannot step, as in the JAX package).  Files are read with the port's own
HDF5 module (util/hdf5.py), so no h5py is needed.
"""

import importlib

import torch

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.defaults import dtype as working_dtype
from pyro2_tpu_torch.defaults import resolve_device
from pyro2_tpu_torch.mesh.grid import Cartesian2d, SphericalPolar
from pyro2_tpu_torch.mesh.patch import CellCenterData2d
from pyro2_tpu_torch.util import hdf5

__all__ = ["read", "read_bcs"]


def read_bcs(f):
    """The custom-BC record of an open file ({name: is_solid dataset}),
    or None."""
    try:
        gb = f["BC"]
    except KeyError:
        return None
    return {name: gb[name] for name in gb}


def read(filename, *, device=None, dtype=None):
    """Read an HDF5 output: the Simulation it holds, or the bare
    CellCenterData2d of a file written without one.  `device` defaults to
    CUDA (raising without one), `dtype` to the device's working dtype."""
    device = resolve_device(device)
    dtype = working_dtype(device, dtype)
    filename = str(filename)
    if not filename.endswith(".h5"):
        filename += ".h5"

    with hdf5.File(filename, "r") as f:
        try:
            solver_name = f.attrs["solver"]
            problem_name = f.attrs["problem"]
            t = f.attrs["time"]
            n = f.attrs["nsteps"]
        except KeyError:
            solver_name = None

        grid = f["grid"].attrs
        coord_type = grid.get("coord_type", 0)
        grid_class = SphericalPolar if coord_type == 1 else Cartesian2d
        myg = grid_class(int(grid["nx"]), int(grid["ny"]), ng=int(grid["ng"]),
                         xmin=float(grid["xmin"]), xmax=float(grid["xmax"]),
                         ymin=float(grid["ymin"]), ymax=float(grid["ymax"]))

        # re-register any custom BCs before variable creation needs them;
        # is_solid is the file's dataset object, and a dataset is truthy
        # whatever it holds, so every one registers solid, as the JAX
        # package's read does: its behaviour, kept; section C.4 of
        # ROADMAP.md records it
        custom_bcs = read_bcs(f)
        if custom_bcs is not None:
            if solver_name in ["compressible_fv4", "compressible_rk",
                               "compressible_sdc"]:
                bc_solver = "compressible"
            else:
                bc_solver = solver_name
            bcmod = importlib.import_module(
                f"pyro2_tpu_torch.solvers.{bc_solver}.BC")
            for name, is_solid in custom_bcs.items():
                bnd.define_bc(name, bcmod.user, is_solid=bool(is_solid))

        gs = f["state"]
        names = list(gs)

        myd = CellCenterData2d(myg, dtype=dtype, device=device)
        for name in names:
            grp = gs[name]
            bc = bnd.BC(xlb=grp.attrs["xlb"], xrb=grp.attrs["xrb"],
                        ylb=grp.attrs["ylb"], yrb=grp.attrs["yrb"])
            myd.register_var(name, bc)
        myd.create()

        for k in f["aux"].attrs:
            myd.set_aux(k, f["aux"].attrs[k])

        valid = (slice(myg.ilo, myg.ihi + 1), slice(myg.jlo, myg.jhi + 1))
        for i, name in enumerate(names):
            myd.data[(i, *valid)] = torch.as_tensor(
                gs[name]["data"][...], dtype=dtype).to(device)

        # particles: an "array" set with no boundary conditions
        my_particles = None
        if "particles" in f:
            from pyro2_tpu_torch.particles import Particles
            gp = f["particles"]
            pos = gp["particle_positions"][...]
            my_particles = Particles(myd, None, len(pos), "array", pos,
                                     gp["init_particle_positions"][...])

        if solver_name is None:
            return myd

        solver = importlib.import_module(
            f"pyro2_tpu_torch.solvers.{solver_name}")
        sim = solver.Simulation(solver_name, problem_name, None, None,
                                device=device, dtype=dtype)
        sim.n = int(n)
        sim.cc_data = myd
        sim.cc_data.t = float(t)
        sim.particles = my_particles
        sim.read_extras(f)

        # walk the MRO to find the solver family's derives module
        for mod in [cls.__module__ for cls in type(sim).__mro__
                    if cls is not object]:
            try:
                derives = importlib.import_module(
                    mod.replace("simulation", "derives"))
                sim.cc_data.add_derived(derives.derive_primitives)
            except (ModuleNotFoundError, AttributeError):
                continue
            else:
                break
        return sim
