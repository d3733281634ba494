"""The port's regression and checkpoint layer against pyro2_tpu's: the HDF5
module, io_pyro.read, compare, PyroBenchmark and the regression driver.

Everything runs on the CPU in float64 (JAX x64).  Tolerances:
  * util/hdf5.py against h5py on the 16 goldens: every group, dataset and
    attribute, its type and value, equal; files it writes read back by
    h5py equal;
  * io_pyro.read of every golden against the JAX package's read: grid,
    names, BCs, aux, t, n and every cell of the state (ghosts included)
    bit for bit, and the BC registry's solid flags after the read equal
    (both register every custom BC of a compressible file solid, ROADMAP.md
    C.4);
  * a port write of compressible rt, cavity and lm_atm states, read back
    by both packages' read: bit for bit;
  * compare against the JAX package's compare on constructed states: the
    same result and the same printed report;
  * the regression driver: the JAX package's 16 runs, and seven of them
    (the four advection runs, burgers-test, compressible-sod and swe-dam)
    passing at rtol 1e-12 against the port's golden copies.  The other
    nine goldens are held by the tests/test_torch_*_golden.py files;
  * burgers' verify.py on two written files: the JAX verify's output.
"""

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyro2_tpu.mesh.boundary as jbnd
import pyro2_tpu.util.compare as jcompare
import pyro2_tpu.util.io_pyro as jio
import pyro2_tpu_torch.mesh.boundary as bnd
import pyro2_tpu_torch.pyro_sim as pyro_sim
from pyro2_tpu import test as jtest
from pyro2_tpu.mesh.grid import Cartesian2d as JGrid
from pyro2_tpu.mesh.patch import CellCenterData2d as JData
from pyro2_tpu.solvers.burgers.problems import verify as jverify
from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch import test as driver
from pyro2_tpu_torch.mesh.grid import Cartesian2d
from pyro2_tpu_torch.mesh.patch import CellCenterData2d
from pyro2_tpu_torch.multigrid import mg_kernel
from pyro2_tpu_torch.solvers.burgers.problems import verify
from pyro2_tpu_torch.solvers.incompressible_viscous import BC as cavity_bc
from pyro2_tpu_torch.util import compare, hdf5, io_pyro

h5py = pytest.importorskip("h5py")

ROOT = Path(__file__).resolve().parents[1]
GOLDENS = sorted((ROOT / "pyro2_tpu" / "solvers").glob("*/tests/*.h5"))
GOLDEN_IDS = [f"{p.parents[1].name}/{p.name}" for p in GOLDENS]


@pytest.fixture(autouse=True)
def _bc_registries():
    """Restore both packages' BC registries (module-level dicts that a
    read fills) after each test."""
    saved = [(m.bc_solid.copy(), m.ext_bcs.copy()) for m in (jbnd, bnd)]
    yield
    for m, (solid, ext) in zip((jbnd, bnd), saved):
        m.bc_solid.clear()
        m.bc_solid.update(solid)
        m.ext_bcs.clear()
        m.ext_bcs.update(ext)


def test_sixteen_goldens():
    assert len(GOLDENS) == 16


# -- util/hdf5.py -------------------------------------------------------------

def _same_tree(a, b, path="/"):
    """a (h5py) and b (util/hdf5) hold the same tree, types included."""
    assert sorted(a.attrs) == sorted(b.attrs), path
    for k in a.attrs:
        va, vb = a.attrs[k], b.attrs[k]
        assert type(va) is type(vb), (path, k, type(va), type(vb))
        assert np.array_equal(va, vb), (path, k)
    if isinstance(a, h5py.Group):
        assert list(a) == list(b), path
        for name in a:
            _same_tree(a[name], b[name], path + name + "/")
    else:
        va, vb = a[()], b[()]
        assert type(va) is type(vb), path
        assert np.asarray(va).dtype == np.asarray(vb).dtype, path
        assert np.array_equal(va, vb), path


@pytest.mark.parametrize("golden", GOLDENS, ids=GOLDEN_IDS)
def test_hdf5_reads_each_golden_as_h5py(golden):
    with h5py.File(golden, "r") as a, hdf5.File(golden) as b:
        _same_tree(a, b)


def test_hdf5_writes_what_h5py_reads(tmp_path):
    fn = tmp_path / "w.h5"
    rng = np.random.default_rng(0)
    f64 = rng.standard_normal((5, 7))
    with hdf5.File(fn, "w") as f:
        f.attrs["solver"] = "advection"
        f.attrs["time"] = 0.25
        f.attrs["nsteps"] = np.int64(40)
        f.attrs["flag"] = True
        g = f.create_group("state")
        for name in ("z", "a", "m"):
            v = g.create_group(name)
            v.create_dataset("data", data=f64)
            v.attrs["xlb"] = "periodic"
        f.create_group("BC").create_dataset("hse", data=False)
        f.create_dataset("f32", data=f64.astype(np.float32))
        f.create_dataset("i64", data=np.arange(9).reshape(3, 3))
        f.create_dataset("row", data=rng.standard_normal(11))
        f.create_group("empty")
        many = f.create_group("many")
        for i in range(40):
            many.create_dataset(f"d{i:02d}", data=float(i))
        rp = f.create_group("runtime parameters")
        for i in range(300):
            rp.attrs[f"section.key{i:03d}"] = [1.5, 2, f"text {i}"][i % 3]
    with h5py.File(fn, "r") as a, hdf5.File(fn) as b:
        _same_tree(a, b)
        assert a.attrs["solver"] == "advection"
        assert a["BC/hse"].shape == () and not a["BC/hse"][()]
        assert np.array_equal(a["state/m/data"][...], f64)
        assert a["f32"].dtype == np.float32
        assert list(a["many"]) == [f"d{i:02d}" for i in range(40)]
        assert a["runtime parameters"].attrs["section.key299"] == "text 299"


def test_hdf5_refuses_what_it_does_not_read(tmp_path):
    chunked = tmp_path / "chunked.h5"
    with h5py.File(chunked, "w") as f:
        f.create_dataset("d", data=np.zeros((8, 8)), chunks=(4, 4))
    latest = tmp_path / "latest.h5"
    with h5py.File(latest, "w", libver="latest") as f:
        f.create_group("g")
    for fn in (chunked, latest):
        with pytest.raises(NotImplementedError):
            hdf5.File(fn)
    (tmp_path / "text.h5").write_text("not hdf5")
    with pytest.raises(OSError):
        hdf5.File(tmp_path / "text.h5")


def test_a_dataset_is_truthy_as_h5pys_is():
    golden = ROOT / "pyro2_tpu/solvers/compressible/tests/rt_0307.h5"
    with h5py.File(golden, "r") as a, hdf5.File(golden) as b:
        for name in ("hse", "ambient"):
            assert not a["BC"][name][()] and not b["BC"][name][()]
            assert bool(a["BC"][name]) and bool(b["BC"][name])


# -- io_pyro.read -------------------------------------------------------------

def _same_state(jd, td):
    """A JAX and a port CellCenterData2d hold the same state, by bits."""
    jg, g = jd.grid, td.grid
    assert type(jg).__name__ == type(g).__name__
    for att in ("nx", "ny", "ng", "xmin", "xmax", "ymin", "ymax"):
        assert getattr(jg, att) == getattr(g, att), att
    assert jd.names == td.names
    for name in jd.names:
        jb, b = jd.BCs[name], td.BCs[name]
        assert (jb.xlb, jb.xrb, jb.ylb, jb.yrb) == (b.xlb, b.xrb, b.ylb,
                                                      b.yrb), name
    assert sorted(jd.aux) == sorted(td.aux)
    for k in jd.aux:
        assert jd.aux[k] == td.aux[k], k
    assert jd.t == td.t
    assert td.data.dtype == torch.float64 and td.data.device.type == "cpu"
    assert np.array_equal(np.asarray(jd.data), td.data.numpy())


@pytest.mark.parametrize("golden", GOLDENS, ids=GOLDEN_IDS)
def test_read_matches_jax_read(golden):
    with h5py.File(golden, "r") as f:
        custom = list(f["BC"]) if "BC" in f else []
    js = jio.read(str(golden))
    ts = io_pyro.read(golden, device="cpu")
    assert ts.n == js.n and type(ts.n) is int
    assert ts.solver_name == js.solver_name
    assert ts.problem_name == js.problem_name
    assert type(ts).__module__ == \
        type(js).__module__.replace("pyro2_tpu.", "pyro2_tpu_torch.")
    _same_state(js.cc_data, ts.cc_data)
    assert len(ts.cc_data.derives) == len(js.cc_data.derives)
    for name in custom:
        assert bnd.bc_solid[name] == jbnd.bc_solid[name] is True
    if ts.solver_name == "lm_atm":
        assert sorted(ts.base) == sorted(js.base)
        for name in js.base:
            assert np.array_equal(ts.base[name].d, js.base[name].d)


def test_read_keeps_its_device_and_dtype():
    golden = ROOT / "pyro2_tpu/solvers/swe/tests/dam_x_0081.h5"
    s = io_pyro.read(str(golden)[:-3], device="cpu", dtype=torch.float32)
    assert s.cc_data.data.dtype == torch.float32
    assert s.dtype == torch.float32 and s.device.type == "cpu"
    with h5py.File(golden, "r") as f:
        ref = f["state/height/data"][()]
    g = s.cc_data.grid
    got = s.cc_data.get_var("height")[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]
    assert np.array_equal(got.numpy(), ref.astype(np.float32))


def test_read_derives_variables_through_the_mro():
    golden = ROOT / "pyro2_tpu/solvers/compressible_rk/tests/rt_0307.h5"
    s = io_pyro.read(golden, device="cpu")
    j = jio.read(str(golden))
    p = s.cc_data.get_var("pressure")
    # the ghosts read back as zeros: pressure is NaN there in both
    assert np.array_equal(p.numpy(), np.asarray(j.cc_data.get_var(
        "pressure")), equal_nan=True)
    g = s.cc_data.grid
    assert torch.isfinite(p[g.ilo:g.ihi + 1, g.jlo:g.jhi + 1]).all()


def test_a_file_with_particles_waits_for_a17(tmp_path):
    """A file with a particles group reads (A.17 is done; the name is the
    test's from before): a golden with two particles added by h5py reads
    back in both packages as an "array" Particles with no boundary
    conditions, positions equal by bits."""
    fn = tmp_path / "p.h5"
    shutil.copy(ROOT / "pyro2_tpu/solvers/advection/tests/smooth_0040.h5",
                fn)
    pos = np.array([[0.25, 0.5], [0.75, 0.125]])
    init = np.array([[0.2, 0.4], [0.7, 0.1]])
    with h5py.File(fn, "a") as f:
        g = f.create_group("particles")
        g.create_dataset("particle_positions", data=pos)
        g.create_dataset("init_particle_positions", data=init)
    s = io_pyro.read(fn, device="cpu")
    j = jio.read(str(fn))
    for got, ref in ((s.particles.positions.numpy(), pos),
                     (s.particles.init_positions.numpy(), init),
                     (np.asarray(j.particles.positions), pos)):
        assert np.array_equal(got, ref)
    assert s.particles.bc is None and bool(s.particles.active.all())


def _written(tmp_path, solver, problem, inputs, steps):
    p = Pyro(solver, device="cpu")
    p.initialize_problem(problem, inputs_dict=inputs)
    for _ in range(steps):
        p.single_step()
    fn = str(tmp_path / f"{solver}_{problem}")
    p.sim.write(fn)
    return p.sim, fn + ".h5"


WRITES = [("compressible", "rt", {"mesh.nx": 16, "mesh.ny": 48}, 3),
          ("incompressible_viscous", "cavity",
           {"mesh.nx": 16, "mesh.ny": 16}, 2),
          ("lm_atm", "bubble", {"mesh.nx": 16, "mesh.ny": 16}, 1)]


@pytest.mark.parametrize("solver,problem,inputs,steps", WRITES)
def test_a_port_write_reads_back_in_both_packages(tmp_path, solver, problem,
                                                  inputs, steps):
    sim, fn = _written(tmp_path, solver, problem, inputs, steps)
    ts = io_pyro.read(fn, device="cpu")
    js = jio.read(fn)
    assert ts.n == js.n == sim.n == steps
    assert ts.cc_data.t == js.cc_data.t == sim.cc_data.t
    _same_state(js.cc_data, ts.cc_data)
    # the file lists the variables by name, and a read registers them so
    g = sim.cc_data.grid
    assert ts.cc_data.names == sorted(sim.cc_data.names)
    valid = (slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
    for name in sim.cc_data.names:
        assert torch.equal(ts.cc_data.get_var(name)[valid],
                           sim.cc_data.get_var(name)[valid]), name
    if solver == "lm_atm":
        for name, b in sim.base.items():
            assert np.array_equal(ts.base[name].d, b.d)
            assert np.array_equal(js.base[name].d, b.d)
    with h5py.File(fn, "r") as f:
        assert f.attrs["solver"] == solver
        assert len(f["runtime parameters"].attrs) == len(sim.rp.params)


def test_a_read_cavity_takes_the_zero_edge(tmp_path):
    _, fn = _written(tmp_path, "incompressible_viscous", "cavity",
                     {"mesh.nx": 16, "mesh.ny": 16}, 1)
    s = io_pyro.read(fn, device="cpu")
    assert bnd.ext_bcs["moving_lid"] is cavity_bc.user
    assert bnd.bc_solid["moving_lid"] is True
    for name in ("x-velocity", "y-velocity"):
        kinds = mg_kernel.edge_kinds(s.cc_data.BCs[name])
        assert kinds[3] == mg_kernel.ZERO


# -- compare ------------------------------------------------------------------

def _pair_states(names, nx=8, ny=6, seed=0, ny2=None, names2=None,
                 delta=None):
    base = np.random.default_rng(seed).uniform(0.5, 2.0, (3, nx + 4,
                                                          max(ny, ny2 or 0)
                                                          + 4))
    out = []
    for k, (nms, n_y) in enumerate(((names, ny), (names2 or names,
                                                  ny2 or ny))):
        jg = JGrid(nx, n_y, ng=2)
        g = Cartesian2d(nx, n_y, ng=2)
        jd = JData(jg)
        td = CellCenterData2d(g, device="cpu")
        for name in nms:
            bc = jbnd.BC(xlb="periodic", xrb="periodic", ylb="periodic",
                         yrb="periodic")
            jd.register_var(name, bc)
            td.register_var(name, bnd.BC(xlb="periodic", xrb="periodic",
                                         ylb="periodic", yrb="periodic"))
        jd.create()
        td.create()
        a = base[:len(nms), :g.qx, :g.qy].copy()
        a[-1, g.ilo, g.jlo] = 0.0          # a zero: absolute error only
        if k == 1 and delta is not None:
            a[0, g.ilo + 1, g.jlo + 1] += delta
        jd.set_vars(jnp.asarray(a))
        td.set_vars(a)
        out.append((jd, td))
    return out


CASES = {"0": {}, "within_rtol": {"delta": 1e-13},
         "varerr": {"delta": 1e-6},
         "gridbad": {"ny2": 7},
         "namesbad": {"names2": ["density", "energy"]}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_matches_jax(case, capsys):
    (j1, t1), (j2, t2) = _pair_states(["density", "x-momentum"],
                                      **CASES[case])
    ref = jcompare.compare(j1, j2, 1e-12)
    jout = capsys.readouterr().out
    got = compare.compare(t1, t2, 1e-12)
    assert got == ref
    assert capsys.readouterr().out == jout
    expect = 0 if case in ("0", "within_rtol") else case
    assert got == expect


def test_compare_keeps_numpys_default_atol():
    """A difference far above rtol*|d2| near zero passes through allclose's
    atol of 1e-8, as it does in the JAX package."""
    (j1, t1), (j2, t2) = _pair_states(["density"], delta=None)
    g = t1.grid
    t2.data[0, g.ilo, g.jlo] = 3.5e-15
    j2.set_vars(jnp.asarray(t2.data.numpy()))
    assert compare.compare(t1, t2, 1e-12) == \
        jcompare.compare(j1, j2, 1e-12) == 0


def test_compare_main_reads_two_files(tmp_path, capsys):
    golden = ROOT / "pyro2_tpu/solvers/advection/tests/smooth_0040.h5"
    assert compare.main(["--device", "cpu", str(golden), str(golden)]) == 0
    assert "SUCCESS: files agree" in capsys.readouterr().out
    other = ROOT / "pyro2_tpu/solvers/advection_rk/tests/smooth_0081.h5"
    assert compare.main(["--device", "cpu", str(golden), str(other),
                         "1e-12"]) == "varerr"


# -- PyroBenchmark and the regression driver ---------------------------------

def test_the_driver_runs_the_jax_packages_sixteen():
    ours = [(str(t), t.solver, t.problem, t.inputs, t.options)
            for t in driver.get_test_list()]
    theirs = [(str(t), t.solver, t.problem, t.inputs, t.options)
              for t in jtest.get_test_list()]
    assert ours == theirs and len(ours) == 16


DRIVER_RUNS = ["advection-smooth", "advection_nonuniform-slotted",
               "advection_rk-smooth", "advection_fv4-smooth",
               "burgers-test", "compressible-sod", "swe-dam"]


@pytest.mark.parametrize("single", DRIVER_RUNS)
def test_driver_single_passes_on_the_cpu(single, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "results.out"
    assert driver.do_tests(str(out), single=single, device="cpu") == 0
    text = out.read_text()
    assert f"{single:42} passed" in text and "0 test(s) failed" in text
    assert not (tmp_path / "test_outputs").exists()


def test_driver_main_exits_with_the_failure_count(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        driver.main(["--device", "cpu", "--single", "advection-smooth",
                     "--rtol", "1e-12"])
    assert exc.value.code == 0
    # the multigrid analytic solves alone, at 16^2: one within 10% of
    # JAX's L2 error, one held to twice it, which fails
    fn = driver.MG_EXPECTED["mg_poisson_dirichlet"][1]
    jfn = jtest.MG_EXPECTED["mg_poisson_dirichlet"][1]
    monkeypatch.setattr(driver, "MG_EXPECTED", {
        "right": (16, fn, jfn(16)), "wrong": (16, fn, 2.0 * jfn(16))})
    with pytest.raises(SystemExit) as exc:
        driver.main(["--device", "cpu", "--multigrid_only"])
    assert exc.value.code == 1


def test_benchmark_reports_a_mismatch_and_stores(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    inputs = {"driver.verbose": 0, "io.force_final_output": 1}
    p = pyro_sim.PyroBenchmark("advection", comp_bench=True, device="cpu")
    p.initialize_problem("smooth", inputs_file="inputs.smooth",
                         inputs_dict={**inputs, "advection.u": 0.9})
    assert p.run_sim() == "varerr"
    assert p.sim.cc_data.data.dtype == torch.float64

    # a benchmark made under another package root compares equal there
    home = str(tmp_path / "home") + "/"
    p = pyro_sim.PyroBenchmark("advection", make_bench=True, device="cpu")
    p.initialize_problem("smooth", inputs_file="inputs.smooth",
                         inputs_dict=inputs)
    p.pyro_home = home
    assert p.run_sim() is p.sim
    stored = Path(home) / "solvers/advection/tests/smooth_0040.h5"
    with h5py.File(stored, "r") as f:
        assert int(f.attrs["nsteps"]) == 40
    p = pyro_sim.PyroBenchmark("advection", comp_bench=True, device="cpu")
    p.initialize_problem("smooth", inputs_file="inputs.smooth",
                         inputs_dict={**inputs, "driver.max_steps": 3})
    p.pyro_home = home
    assert p.run_sim() == "ERROR opening compare file"


def test_cli_compares_to_the_benchmark(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert pyro_sim.main(["--device", "cpu", "--compare_benchmark",
                          "advection", "smooth", "inputs.smooth",
                          "io.force_final_output=1"]) == 0


# -- burgers verify -----------------------------------------------------------

def test_verify_reads_two_files_as_jax_does(tmp_path, capsys):
    p = Pyro("burgers", device="cpu")
    p.initialize_problem("test", inputs_dict={"mesh.nx": 32,
                                              "mesh.ny": 32})
    files = []
    for k in range(12):
        p.single_step()
        if k in (3, 11):
            files.append(str(tmp_path / f"test_{k:04d}"))
            p.sim.write(files[-1])
    capsys.readouterr()
    ref = jverify.verify(*files)
    jout = capsys.readouterr().out
    got = verify.verify(*files, device="cpu")
    assert got == ref
    assert capsys.readouterr().out == jout
    assert verify.main(["--device", "cpu", *files]) == ref
