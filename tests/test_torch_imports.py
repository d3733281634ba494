"""The PyTorch port stands alone: it imports neither JAX nor pyro2_tpu, and
its entry points never fall back to the CPU when there is no GPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pyro2_tpu_torch"


def _imported_modules(path):
    """Every module name an `import` / `from ... import` in `path` names."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            names.append(node.module)
    return names


def _forbidden(name):
    top = name.split(".")[0]
    # exact module names: pyro2_tpu_torch starts with "pyro2_tpu"
    return top in ("jax", "jaxlib", "pyro2_tpu")


def test_no_jax_or_pyro2_tpu_import_in_source():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), n) for f in files
           for n in _imported_modules(f) if _forbidden(n)]
    assert bad == []


def test_forbidden_matches_exact_module_names():
    assert _forbidden("jax.numpy") and _forbidden("pyro2_tpu.mesh.grid")
    assert _forbidden("pyro2_tpu")
    assert not _forbidden("pyro2_tpu_torch.mesh.grid")


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import pyro2_tpu_torch\n"
        "import pyro2_tpu_torch.solvers.compressible\n"
        "import pyro2_tpu_torch.solvers.compressible.ctu_kernel\n"
        "from pyro2_tpu_torch.solvers.compressible.problems import "
        "advect, kh, quad, rt, sod\n"
        "import pyro2_tpu_torch.util.carry\n"
        "import pyro2_tpu_torch.util.cuda_build\n"
        "import pyro2_tpu_torch.multigrid.MG\n"
        "import pyro2_tpu_torch.multigrid.mg_kernel\n"
        "import pyro2_tpu_torch.solvers.diffusion\n"
        "import pyro2_tpu_torch.solvers.burgers\n"
        "import pyro2_tpu_torch.solvers.incompressible\n"
        "from pyro2_tpu_torch.solvers.diffusion.problems import "
        "gaussian, test\n"
        "from pyro2_tpu_torch.solvers.incompressible.problems import "
        "converge, shear\n"
        "import pyro2_tpu_torch.mesh.integration\n"
        "import pyro2_tpu_torch.mesh.fv\n"
        "import pyro2_tpu_torch.mesh.fourth_order\n"
        "import pyro2_tpu_torch.solvers.compressible_rk\n"
        "import pyro2_tpu_torch.solvers.compressible_rk.fluxes\n"
        "import pyro2_tpu_torch.solvers.compressible_fv4\n"
        "import pyro2_tpu_torch.solvers.compressible_fv4.fluxes\n"
        "import pyro2_tpu_torch.solvers.compressible_fv4.mol_kernel\n"
        "import pyro2_tpu_torch.solvers.compressible_sdc\n"
        "from pyro2_tpu_torch.solvers.compressible.problems import "
        "acoustic_pulse, test\n"
        "import pyro2_tpu_torch.solvers.swe\n"
        "import pyro2_tpu_torch.solvers.swe.swe_kernel\n"
        "from pyro2_tpu_torch.solvers.swe.problems import acoustic_pulse, "
        "advect, dam, kh, logo, quad, test\n"
        "import pyro2_tpu_torch.multigrid.edge_coeffs\n"
        "import pyro2_tpu_torch.multigrid.variable_coeff_MG\n"
        "import pyro2_tpu_torch.multigrid.general_MG\n"
        "import pyro2_tpu_torch.solvers.lm_atm\n"
        "import pyro2_tpu_torch.solvers.lm_atm.lm_kernel\n"
        "from pyro2_tpu_torch.solvers.lm_atm.problems import bubble\n"
        "for s in ('rk', 'fv4', 'sdc'):\n"
        "    __import__('pyro2_tpu_torch.solvers.compressible_' + s + "
        "'.problems.acoustic_pulse')\n"
        "import pyro2_tpu_torch.analysis\n"
        "for m in ('exact_riemann', 'convergence', 'smooth_error', "
        "'sod_compare', 'dam_compare', 'sedov_compare', "
        "'gauss_diffusion_compare', 'incomp_converge_error', "
        "'incomp_viscous_converge_error', 'convergence_plot', 'plotvar', "
        "'plotcompact', 'plot_thumbnail'):\n"
        "    __import__('pyro2_tpu_torch.analysis.' + m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pyro2_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_spherical_and_padded_slice_imports_without_cuda_or_jax():
    # the modules of the spherical / padded-frame / ensemble slice, and the
    # problems that came with it, import on a machine with neither CUDA
    # nor JAX in the process
    code = (
        "import sys\n"
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "import pyro2_tpu_torch.solvers.compressible.padded_step as ps\n"
        "import pyro2_tpu_torch.parallel\n"
        "from pyro2_tpu_torch.parallel import ensemble_states, "
        "ensemble_step\n"
        "from pyro2_tpu_torch.solvers.compressible.problems import "
        "bubble, gresho, hse, logo, ramp, rt2, rt_multimode, sedov\n"
        "assert set(ps.launches) == {'ctu_periodic', 'ctu_padin', "
        "'ctu_ensemble', 'ctu_periodic_s1', 'ctu_periodic_s2', "
        "'ctu_periodic_s3'}\n"
        "assert {'ensemble_states', 'ensemble_step'} <= "
        "set(pyro2_tpu_torch.parallel.__all__)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pyro2_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.defaults import resolve_device

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pyro("compressible")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    p = Pyro("compressible", device="cpu")
    assert p.dtype == torch.float64


@pytest.mark.parametrize("solver", ["diffusion", "incompressible",
                                    "compressible_rk", "compressible_fv4",
                                    "compressible_sdc", "swe", "lm_atm"])
def test_multigrid_solvers_raise_without_cuda(monkeypatch, tmp_path, solver):
    from pyro2_tpu_torch import Pyro

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pyro(solver)
    p = Pyro(solver, device="cpu")
    assert p.dtype == torch.float64


def test_carry_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch,
                                                        tmp_path):
    # carry and carry_simulation resolve their device as every entry point
    # does: CUDA by default, raising without a GPU; on the CPU, float64
    import numpy as np

    from pyro2_tpu_torch.util.carry import carry, carry_simulation

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {"mesh.nx": 8, "mesh.ny": 8}
    state = np.zeros((4, 12, 12))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        carry(params, state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        carry_simulation("compressible", "sod", params, state)
    _, U = carry(params, state, device="cpu")
    assert U.dtype == torch.float64 and U.device.type == "cpu"
    from pyro2_tpu_torch import Pyro

    p = Pyro("compressible", device="cpu")
    p.initialize_problem("sod", inputs_dict={"mesh.nx": 8, "mesh.ny": 8})
    sim = carry_simulation("compressible", "sod", p.rp.params,
                           p.sim.cc_data.data.numpy(), device="cpu")
    assert sim.cc_data.data.dtype == torch.float64
    assert torch.equal(sim.cc_data.data, p.sim.cc_data.data)


def test_state_containers_run_on_the_card_unless_asked_for_the_cpu(
        monkeypatch):
    # CellCenterData2d and Grid2d.scratch_array resolve their device as
    # every entry point does: CUDA by default, raising without a GPU; on
    # the CPU, float64
    from pyro2_tpu_torch import CellCenterData2d, Grid2d

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = Grid2d(8, 8, ng=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CellCenterData2d(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        g.scratch_array()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        g.scratch_array(nvar=3, dtype=torch.float32)
    d = CellCenterData2d(g, device="cpu")
    assert d.device.type == "cpu" and d.dtype == torch.float64
    d.register_var("a", None)
    d.create()
    assert d.data.dtype == torch.float64 and d.data.device.type == "cpu"
    a = g.scratch_array(device="cpu")
    assert a.shape == (12, 12) and a.dtype == torch.float64
    b = g.scratch_array(nvar=3, dtype=torch.float32, device="cpu")
    assert b.shape == (3, 12, 12) and b.dtype == torch.float32
    assert CellCenterData2d(g, dtype=torch.float32,
                            device="cpu").dtype == torch.float32


def test_build_directory_stays_git_ignored():
    # the libraries nvcc builds at first use are never committed
    from pyro2_tpu_torch.util import cuda_build

    lines = (ROOT / ".gitignore").read_text().split()
    assert "pyro2_tpu_torch/_build/" in lines
    assert cuda_build.BUILD_DIR == PORT / "_build"


def test_chip_smoke_refuses_without_cuda(tmp_path):
    # alone in a directory and without a GPU, it fails and prints no result
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_sharded_slice_imports_without_cuda_or_jax():
    # the mesh layer, the launcher, the sharded multigrid with its kernel
    # wrapper, ShardedDiffusion, the sharded hyperbolic and MOL tiers, the
    # solvers with inline sharded solves (lm_atm's too), the overlapped
    # step and the accounting import on a machine with
    # neither CUDA nor JAX in the process, and never initialise
    # torch.distributed
    code = (
        "import sys\n"
        "import torch\n"
        "import torch.distributed as dist\n"
        "assert not torch.cuda.is_available()\n"
        "import pyro2_tpu_torch.parallel as par\n"
        "from pyro2_tpu_torch.parallel import accounting, blocks, launch, "
        "mesh_comm, overlap, sharded, sharded_burgers_viscous, "
        "sharded_diffusion, sharded_hyperbolic, sharded_incompressible, "
        "sharded_lm_atm, sharded_mg, sharded_mol, sharded_particles\n"
        "from pyro2_tpu_torch.multigrid import sharded_mg_kernel as smk\n"
        "from pyro2_tpu_torch.util.carry import carry_block\n"
        "assert set(par.__all__) == {'Mesh', 'ShardedAdvection', "
        "'ShardedBurgers', 'ShardedBurgersViscous', 'ShardedCompressible', "
        "'ShardedCompressibleFV4', 'ShardedCompressibleRK', "
        "'ShardedCompressibleSDC', 'ShardedDiffusion', "
        "'ShardedGeneralMG', 'ShardedIncompressible', "
        "'ShardedIncompressibleViscous', 'ShardedLMAtm', 'ShardedMG', "
        "'ShardedSWE', 'ShardedSim', "
        "'ShardedVarCoeffMG', 'build_overlapped_step', 'collective_stats', "
        "'ensemble_states', 'ensemble_step', "
        "'factor_devices', 'halo_exchange', 'halo_stats', 'make_mesh', "
        "'make_sharded_compressible_step', 'make_sharded_mg', "
        "'make_sharded_particle_advance'}\n"
        "assert set(smk.launches) == {'mg_deep_smooth', 'mg_correct', "
        "'mg_sweep'}\n"
        "assert smk.SOURCE.name == 'mg_deep.cu' and smk._lib is None\n"
        "assert not dist.is_initialized()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pyro2_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_rank_programs_import_no_jax():
    # the sharded tests' ranks unpickle their programs by importing this
    # module: it must not pull JAX into them
    code = ("import sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import torch_rank_programs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'pyro2_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_advection_and_regression_layer_import_no_jax_and_no_h5py():
    # the advection solvers, the HDF5 module, io_pyro, compare and the
    # regression driver import without JAX, pyro2_tpu, triton or h5py
    # (the card's machine has no h5py: the port reads and writes its own)
    code = (
        "import sys\n"
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "for s in ('advection', 'advection_nonuniform', 'advection_rk', "
        "'advection_fv4', 'advection_weno'):\n"
        "    __import__('pyro2_tpu_torch.solvers.' + s)\n"
        "from pyro2_tpu_torch.solvers.advection.problems import smooth, "
        "test, tophat\n"
        "from pyro2_tpu_torch.solvers.advection_nonuniform.problems import "
        "slotted\n"
        "from pyro2_tpu_torch.solvers.advection_weno.problems import "
        "smooth\n"
        "from pyro2_tpu_torch.solvers.advection_weno import fluxes\n"
        "from pyro2_tpu_torch.solvers.advection_fv4 import fluxes\n"
        "from pyro2_tpu_torch.solvers.advection_nonuniform import "
        "advective_fluxes\n"
        "from pyro2_tpu_torch.mesh.reconstruction import weno, weno_upwind\n"
        "from pyro2_tpu_torch.util import compare, hdf5, io_pyro\n"
        "from pyro2_tpu_torch.solvers.burgers.problems import verify\n"
        "import pyro2_tpu_torch.test as driver\n"
        "from pyro2_tpu_torch.pyro_sim import PyroBenchmark\n"
        "assert len(driver.get_test_list()) == 16\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pyro2_tpu', 'triton', 'h5py')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_advection_read_and_benchmark_run_on_the_card(monkeypatch, tmp_path):
    # Pyro("advection"), io_pyro.read and PyroBenchmark resolve their
    # device as every entry point does: CUDA by default, raising without a
    # GPU; on the CPU, float64
    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.pyro_sim import PyroBenchmark
    from pyro2_tpu_torch.util import io_pyro

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    golden = PORT / "solvers/advection/tests/smooth_0040.h5"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pyro("advection")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        io_pyro.read(golden)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PyroBenchmark("advection", comp_bench=True)
    assert Pyro("advection", device="cpu").dtype == torch.float64
    sim = io_pyro.read(golden, device="cpu")
    assert sim.cc_data.data.dtype == torch.float64
    assert sim.cc_data.data.device.type == "cpu"
    p = PyroBenchmark("advection", comp_bench=True, device="cpu")
    assert p.dtype == torch.float64 and p.device.type == "cpu"


def test_golden_copies_equal_the_jax_packages_files():
    # the regression driver's goldens: the port's copies under its own
    # solvers/<solver>/tests/, byte for byte the JAX package's files
    ref = sorted(p.relative_to(ROOT / "pyro2_tpu")
                 for p in (ROOT / "pyro2_tpu").glob("solvers/*/tests/*.h5"))
    ours = sorted(p.relative_to(PORT)
                  for p in PORT.glob("solvers/*/tests/*.h5"))
    assert ours == ref and len(ref) == 16
    for rel in ref:
        assert (PORT / rel).read_bytes() == \
            (ROOT / "pyro2_tpu" / rel).read_bytes(), rel
