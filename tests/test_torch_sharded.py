"""Parity of the port's sharded hyperbolic tier (pyro2_tpu_torch/parallel/
sharded.py, sharded_hyperbolic.py, sharded_particles.py) with pyro2_tpu's,
and with the port's serial solvers.

Every case runs on gloo ranks of a 2x2 and a 1x4 mesh (one launch each,
all cases in it: torch_rank_programs.sharded_hyperbolic) and on the 1x1
mesh in this process, in float64, each rank from its block of the port's
serial initial interior (util.carry.carry_block), and the JAX package's
run from the same numpy interior.  The cases mirror tests/test_parallel.py:
partition invariance (compressible and swe advect, periodic), spherical
grids (outflow, reflect), particles, the scalar families, solid walls on
split axes, the CFL dt, rt's hse and the ramp's extended BCs.

Tolerances:
* port against port (each mesh against the port's serial run, 1 rank
  against 4): bits.  The block step runs the serial step's operations on
  the same values; the halo and the extended fills put the serial ghosts'
  values in the halos.
* port against the JAX package's sharded classes (a 2x2 mesh of
  conftest's fake CPU devices, the jnp block step): rtol 1e-12 of the
  state's max.  XLA fuses the jitted block step and may contract a
  multiply and an add where torch rounds each.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_rank_programs as trp
from jax.sharding import NamedSharding, PartitionSpec as P

from pyro2_tpu.parallel import make_mesh as jmake_mesh
from pyro2_tpu.parallel import sharded as jsharded
from pyro2_tpu.parallel import sharded_hyperbolic as jhyperbolic
from pyro2_tpu.util.runparams import RuntimeParameters as JRP
from pyro2_tpu_torch.mesh.grid import Cartesian2d
from pyro2_tpu_torch.parallel import ShardedCompressible, launch, make_mesh
from pyro2_tpu_torch.parallel.mesh_comm import halo_exchange_stack
from pyro2_tpu_torch.solvers.compressible import interface
from pyro2_tpu_torch.util.runparams import RuntimeParameters

SOLVER = {"ShardedCompressible": "compressible", "ShardedSWE": "swe",
          "ShardedAdvection": "advection", "ShardedBurgers": "burgers"}
SPH = {"mesh.grid_type": "SphericalPolar", "mesh.xmin": 0.5,
       "mesh.xmax": 1.0, "mesh.ymin": 0.7853981633974483,
       "mesh.ymax": 2.356194490192345, "compressible.riemann": "CGF"}
RT = {"mesh.nx": 32, "mesh.ny": 48, "mesh.xmax": 1.0, "mesh.ymax": 3.0,
      "mesh.xlboundary": "periodic", "mesh.xrboundary": "periodic",
      "mesh.ylboundary": "hse", "mesh.yrboundary": "hse",
      "compressible.grav": -1.0}
RAMP = {"mesh.nx": 32, "mesh.ny": 16, "mesh.xmax": 4.0, "mesh.ymax": 1.0,
        "mesh.xlboundary": "ramp", "mesh.xrboundary": "outflow",
        "mesh.ylboundary": "ramp", "mesh.yrboundary": "ramp",
        "compressible.limiter": 2, "compressible.cvisc": 0.1}
PARTICLES = {"particles.do_particles": 1, "particles.n_particles": 25,
             "particles.particle_generator": "grid"}


def _bcs(kind):
    return {f"mesh.{e}boundary": kind for e in ("xl", "xr", "yl", "yr")}


def _case(cls, problem, overrides, steps, dt, jax=True, **kw):
    return {"cls": cls, "problem": problem, "steps": steps, "dt": dt,
            "overrides": {"mesh.nx": 32, "mesh.ny": 32, **overrides},
            "jax": jax, **kw}


# name -> case; "jax": also run by the JAX package on a 2x2 mesh
CASES = {
    "advect": _case("ShardedCompressible", "advect", _bcs("periodic"), 2,
                    0.002),
    "swe_advect": _case("ShardedSWE", "advect",
                        {**_bcs("periodic"), "swe.grav": 0.001,
                         "swe.limiter": 0}, 2, 0.002),
    "sph_outflow": _case("ShardedCompressible", "advect",
                         {**SPH, **_bcs("outflow")}, 2, 1e-3),
    "sph_reflect": _case("ShardedCompressible", "advect",
                         {**SPH, **_bcs("outflow"),
                          "mesh.ylboundary": "reflect",
                          "mesh.yrboundary": "reflect"}, 2, 1e-3),
    "cfl_dt": _case("ShardedCompressible", "advect", _bcs("periodic"), 3,
                    None),
    "solid_walls": _case("ShardedCompressible", "advect", _bcs("reflect"),
                         2, 0.002),
    "particles": _case("ShardedCompressible", "advect",
                       {**_bcs("periodic"), **PARTICLES}, 2, 0.002,
                       particles=True),
    # a velocity that varies across the seams: the particles' stencils
    # there read the neighbours' post-step cells (JAX reads the pre-step
    # halo, so the port is held to its serial run alone)
    "particles_kh": _case("ShardedCompressible", "kh",
                          {**_bcs("periodic"), **PARTICLES,
                           "particles.n_particles": 400}, 3, None,
                          jax=False, particles=True),
    "advection": _case("ShardedAdvection", "smooth", _bcs("periodic"), 2,
                       1e-3),
    "burgers": _case("ShardedBurgers", "test", _bcs("periodic"), 2, 1e-3),
    "rt_hse": _case("ShardedCompressible", "rt", RT, 2, 0.002),
    "ramp": _case("ShardedCompressible", "ramp", RAMP, 2, 1e-4),
    # shocks through the 1x4 mesh's y = 0.75 seam: the seam faces' viscosity
    "quad_viscosity": _case("ShardedCompressible", "quad", _bcs("outflow"),
                            12, None),
    # a density floor above quad's low quadrant, which the seams cross
    # (the JAX package floors the block interior alone)
    "quad_floor": _case("ShardedCompressible", "quad",
                        {**_bcs("outflow"), "compressible.small_dens": 0.2},
                        4, None, jax=False),
}
NAMES = list(CASES)


def _params(pkg, case):
    """The runtime parameters of a case in a package's RuntimeParameters
    class: the package's defaults, the solver's and the problem's, then
    the overrides."""
    solver = SOLVER[case["cls"]]
    rp = (RuntimeParameters if pkg == "pyro2_tpu_torch" else JRP)()
    rp.load_params(f"{pkg}/_defaults")
    rp.load_params(f"{pkg}/solvers/{solver}/_defaults")
    problem = importlib.import_module(
        f"{pkg}.solvers.{solver}.problems.{case['problem']}")
    for k, v in {**getattr(problem, "PROBLEM_PARAMS", {}),
                 "driver.verbose": 0, "vis.dovis": 0, "io.do_io": 0,
                 **case["overrides"]}.items():
        rp.set_param(k, v, no_new=False)
    return rp


def _rank_cases():
    return [{**c, "params": _params("pyro2_tpu_torch", c).params,
             "U0": _serial(name)[0]} for name, c in CASES.items()]


@pytest.fixture(scope="module")
def runs():
    """{mesh shape: {case: result}} of the port on gloo ranks (2x2, 1x4)
    and in this process (1x1), every rank's gathered result checked equal
    to rank 0's."""
    cases = _rank_cases()
    out = {(1, 1): dict(zip(NAMES, trp.sharded_hyperbolic(
        make_mesh(device="cpu"), cases)))}
    for shape in ((2, 2), (1, 4)):
        ranks = launch.run(trp.sharded_hyperbolic, shape, cases,
                           device="cpu", timeout=600)
        for res in ranks[1:]:
            for a, b in zip(ranks[0], res):
                np.testing.assert_array_equal(a["U"], b["U"])
                assert a["dts"] == b["dts"]
        out[shape] = dict(zip(NAMES, ranks[0]))
    return out


@functools.lru_cache(maxsize=None)
def _serial(name):
    """The port's serial run of a case: (initial interior, final
    interior, dts, final positions, active)."""
    case = CASES[name]
    solver = SOLVER[case["cls"]]
    mod = importlib.import_module(f"pyro2_tpu_torch.solvers.{solver}")
    pmod = importlib.import_module(
        f"pyro2_tpu_torch.solvers.{solver}.problems.{case['problem']}")
    sim = mod.Simulation(solver, case["problem"], pmod.init_data,
                         _params("pyro2_tpu_torch", case), device="cpu")
    sim.initialize()
    g = sim.cc_data.grid

    def interior():
        return sim.cc_data.data[:, g.ilo:g.ihi + 1,
                                g.jlo:g.jhi + 1].numpy().copy()

    U0 = interior()
    sim.cc_data.t = case.get("t0", 0.0)
    dts = []
    for _ in range(case["steps"]):
        sim.cc_data.fill_BC_all()
        if case["dt"] is None:
            sim.method_compute_timestep()
        else:
            sim.dt = case["dt"]
        dts.append(sim.dt)
        sim.evolve()
    parts = sim.particles
    return (U0, interior(), dts,
            None if parts is None else parts.positions.numpy(),
            None if parts is None else parts.active.numpy())


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX package's sharded run of a case on a 2x2 mesh from the
    port's serial initial interior: (final interior, dts, positions,
    active)."""
    case = CASES[name]
    cls = getattr(jsharded if case["cls"] in jsharded.__all__
                  else jhyperbolic, case["cls"])
    mesh = jmake_mesh(shape=(2, 2))
    sh = cls(_params("pyro2_tpu", case), mesh, problem=case["problem"])
    U = jax.device_put(jnp.asarray(_serial(name)[0]),
                       NamedSharding(mesh, P(None, "x", "y")))
    pos = act = None
    if case.get("particles"):
        gs = sh.global_sim
        pos = jnp.asarray(gs.particles.positions)
        act = jnp.asarray(gs.particles.active)
        step_p = sh.build_step_with_particles(gs.particles)
    t, dts = case.get("t0", 0.0), []
    for _ in range(case["steps"]):
        dt = case["dt"] if case["dt"] is not None else sh.compute_dt(U)
        if pos is not None:
            U, pos, act = step_p(U, pos, act, t, dt)
        else:
            U = sh.step(U, t, dt)
        t += dt
        dts.append(dt)
    return (np.asarray(U), dts,
            None if pos is None else np.asarray(pos),
            None if act is None else np.asarray(act))


def _check(runs, name, meshes=((1, 1), (2, 2), (1, 4))):
    """Every mesh's run equals the port's serial run by bits (state, dts,
    particles), and the JAX package's 2x2 run to rtol 1e-12."""
    _, U, dts, pos, active = _serial(name)
    assert np.isfinite(U).all()
    for shape in meshes:
        res = runs[shape][name]
        np.testing.assert_array_equal(res["U"], U, err_msg=str(shape))
        assert res["dts"] == dts, shape
        if pos is not None:
            np.testing.assert_array_equal(res["pos"], pos)
            np.testing.assert_array_equal(res["active"], active)
    if not CASES[name]["jax"]:
        return
    jU, jdts, jpos, jact = _jax(name)
    scale = np.abs(U).max()
    assert np.abs(jU - U).max() <= 1e-12 * scale
    np.testing.assert_allclose(jdts, dts, rtol=1e-12)
    if jpos is not None:
        assert np.abs(jpos - pos).max() <= 1e-12 * np.abs(pos).max()
        np.testing.assert_array_equal(jact, active)


class TestPartitionInvariance:
    @pytest.mark.parametrize("name", ["advect", "swe_advect"])
    def test_sharded_bitwise(self, runs, name):
        _check(runs, name)


class TestShardedSpherical:
    """The block grid's geometry is the block's window of the global
    planes, so both BCs give the serial bits in the port (the JAX package
    holds reflect walls to 1e-14 of the scale against its serial step)."""

    @pytest.mark.parametrize("name", ["sph_outflow", "sph_reflect"])
    def test_spherical_sharded_bitwise(self, runs, name):
        _check(runs, name)

    def test_spherical_cfl_dt(self):
        rp = _params("pyro2_tpu_torch", CASES["sph_outflow"])
        sc = ShardedCompressible(rp, make_mesh(device="cpu"),
                                 problem="advect")
        gs = sc.global_sim
        gs.cc_data.fill_BC_all()
        gs.method_compute_timestep()
        assert sc.compute_dt(sc.init_interior()) == gs.dt


@pytest.mark.parametrize("name", ["advect", "sph_outflow", "rt_hse",
                                  "ramp"])
def test_blockwise_init_matches_global(runs, name):
    """Each rank's problem init on its block grid gives the serial state's
    block, bit for bit (swe advect's fuel, h^2 / max h over the frame, is
    not pointwise: the runs start from the serial state)."""
    for shape in ((1, 1), (2, 2), (1, 4)):
        np.testing.assert_array_equal(runs[shape][name]["blockwise"],
                                      _serial(name)[0])


class TestShardedParticles:
    @pytest.mark.parametrize("name", ["particles", "particles_kh"])
    def test_particles_bitwise(self, runs, name):
        _check(runs, name)
        assert _serial(name)[4].all()


class TestShardedScalarFamilies:
    @pytest.mark.parametrize("name", ["advection", "burgers"])
    def test_partition_invariance(self, runs, name):
        _check(runs, name)


class TestShardedSelfSufficiency:
    def test_pmin_dt_equals_serial_dt(self, runs):
        """Three CFL steps: every mesh's pmin dt is the serial dt."""
        _check(runs, "cfl_dt")

    def test_solid_walls_block_gated_bitwise(self, runs):
        """reflect walls on split axes: only the blocks that own a domain
        edge clamp there (a clamp at a seam would stop the advect flow's
        flux through it)."""
        _check(runs, "solid_walls")
        sc = ShardedCompressible(
            _params("pyro2_tpu_torch", CASES["solid_walls"]),
            make_mesh(device="cpu"), problem="advect")
        assert sc.global_sim.solid.xl == 1 and sc.local_sim.solid.yr == 1

    def test_unknown_bc_rejected(self):
        rp = _params("pyro2_tpu_torch", CASES["advect"])
        rp.set_param("mesh.xlboundary", "no-such-bc", no_new=False)
        with pytest.raises((ValueError, KeyError)):
            ShardedCompressible(rp, make_mesh(device="cpu"),
                                problem="advect")

    def test_source_terms_rejected(self):
        rp = _params("pyro2_tpu_torch", CASES["advect"])
        with pytest.raises(ValueError, match="source_terms"):
            ShardedCompressible(rp, make_mesh(device="cpu"),
                                problem="heating")

    def test_overlap_names_a14(self):
        """The overlapped step that A.14 owed now builds (its bits are
        tests/test_torch_overlap.py's); spherical grids stay refused."""
        rp = _params("pyro2_tpu_torch", CASES["advect"])
        sc = ShardedCompressible(rp, make_mesh(device="cpu"),
                                 problem="advect", overlap=True)
        assert len(sc._overlapped.bands) == 4
        with pytest.raises(ValueError, match="spherical"):
            ShardedCompressible(
                _params("pyro2_tpu_torch", CASES["sph_outflow"]),
                make_mesh(device="cpu"), problem="advect", overlap=True)


class TestShardedExtendedBCs:
    def test_rt_hse_bitwise(self, runs):
        """1 rank against 4 and against the serial run: bits."""
        _check(runs, "rt_hse")

    def test_ext_bc_with_overlap_rejected(self):
        with pytest.raises(ValueError, match="overlapped"):
            ShardedCompressible(_params("pyro2_tpu_torch", CASES["rt_hse"]),
                                make_mesh(device="cpu"), problem="rt",
                                overlap=True)

    def test_exchange_leaves_extended_kinds(self):
        """halo_exchange fills no extended kind: the hse y ghosts keep
        what they held, for the owning ranks' extended fills."""
        sc = ShardedCompressible(_params("pyro2_tpu_torch", CASES["rt_hse"]),
                                 make_mesh(device="cpu"), problem="rt")
        g = sc.local_grid
        rng = np.random.default_rng(3)
        U = torch.as_tensor(rng.random((sc.nvar, g.qx, g.qy)))
        out = halo_exchange_stack(U, g, sc.bcs, sc.mesh)
        assert sc.bcs[0].ylb == "hse"
        lo, hi = slice(0, g.jlo), slice(g.jhi + 1, None)
        inner = slice(g.ilo, g.ihi + 1)
        for ghosts in (lo, hi):
            assert torch.equal(out[:, inner, ghosts], U[:, inner, ghosts])
        # the periodic x ghosts are filled
        assert torch.equal(out[:, :g.ilo, g.jlo:g.jhi + 1],
                           U[:, g.ihi + 1 - g.ng:g.ihi + 1, g.jlo:g.jhi + 1])

    def test_ramp_bitwise(self, runs):
        """The ramp's fills read the block's global coordinates and t."""
        _check(runs, "ramp")


class TestSeams:
    def test_seam_faces_take_viscosity(self, runs):
        """quad's shocks cross the seams: the serial viscosity is nonzero
        on seam faces of both meshes, and every mesh gives the serial bits
        (a seam face with its viscosity zeroed would not)."""
        _check(runs, "quad_viscosity")
        U = _serial("quad_viscosity")[1]
        g = Cartesian2d(32, 32, ng=4)
        u, v = (torch.as_tensor(np.pad(U[k] / U[0], g.ng, mode="edge"))
                for k in (2, 3))
        avx, avy = interface.artificial_viscosity(g, 0.1, u, v)
        # the 2x2 mesh's x seam (x face 16) and the 1x4 mesh's y seams
        assert avx[g.ilo + 16].abs().max() > 0
        assert max(avy[:, g.jlo + j].abs().max() for j in (8, 16, 24)) > 0

    def test_density_floor_on_seam_halos(self, runs):
        """A positive floor above quad's low quadrant: the halo cells the
        serial grid floors as interior ones are floored on every mesh."""
        _check(runs, "quad_floor")
        assert _serial("quad_floor")[0][0].min() < 0.2
