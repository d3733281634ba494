"""What the CTU and MOL kernels' wrappers hand the kernels for the
configurations this slice covers: a problem's energy source (CTU, rk,
fv4), SphericalPolar grids (rk, fv4) and the well-balanced reconstruction
(rk).  The plans' shared-memory layouts with the new planes, the bounds'
arithmetic (`work`), the parameter arrays against the offsets the CUDA
sources read them at, and the buffers (weight plane, spherical lines).
They run on the CPU: nothing is compiled or launched.
"""

import itertools
import re

import numpy as np
import pytest
import torch

from pyro2_tpu_torch import Pyro
from pyro2_tpu_torch.solvers.compressible import ctu_kernel
from pyro2_tpu_torch.solvers.compressible.simulation import energy_rate
from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel
from pyro2_tpu_torch.util import cuda_build

DTYPES = (torch.float32, torch.float64)
SMEM_LIMIT = 232448    # shared memory one block may opt into on the H100
SPH = {"mesh.grid_type": "SphericalPolar", "mesh.nx": 96, "mesh.ny": 32,
       "mesh.xmin": 0.05, "mesh.xmax": 1.0,
       "mesh.ymin": 0.7853981633974483,
       "mesh.ymax": 0.7853981633974483 + 32 * 0.95 / 96,
       "sedov.r_init": 0.1, "compressible.riemann": "CGF"}


def _sim(solver, problem, extra=None):
    p = Pyro(solver, device="cpu")
    p.initialize_problem(problem, inputs_dict={"mesh.nx": 16, "mesh.ny": 16,
                                               **(extra or {})})
    return p.sim


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nvar", range(4, ctu_kernel.MAXVAR + 1))
def test_ctu_plan_holds_the_weight_plane(dtype, nvar):
    """With a problem source the s box holds S's three rows and the weight
    plane, one traced box more than without; the arrays stay one after
    another inside the block's opt-in limit."""
    item = torch.empty((), dtype=dtype).element_size()
    for spherical, flatten in itertools.product((False, True), repeat=2):
        a = ctu_kernel.plan(200, 136, nvar, dtype, spherical=spherical,
                            with_sources=True, flatten=flatten)
        b = ctu_kernel.plan(200, 136, nvar, dtype, spherical=spherical,
                            with_sources=True, flatten=flatten, problem=True)
        traced = b.box("traced")
        assert a.sizes["s"] == 3 * traced and b.sizes["s"] == 4 * traced
        assert b.smem - a.smem == traced * item <= SMEM_LIMIT - a.smem
        end = 0
        for name in b.ARRAYS:
            assert b.offsets[name] == (end if b.sizes[name] else -1)
            end += b.sizes[name]
        assert end * item == b.smem == b.ints()[-3]


@pytest.mark.parametrize("dtype", DTYPES)
def test_ctu_work_counts_the_weight_plane(dtype):
    item = torch.empty((), dtype=dtype).element_size()
    nx, ny = 1024, 1000
    a = ctu_kernel.work(nx, ny, 4, dtype, with_sources=True)
    b = ctu_kernel.work(nx, ny, 4, dtype, with_sources=True, problem=True)
    assert b[0] - a[0] == (nx + 8) * (ny + 8) * item
    assert b[1] - a[1] == ctu_kernel.FLOPS_PER_ZONE_PROBLEM * nx * ny
    c = ctu_kernel.work(nx, ny, 6, dtype, with_sources=True, problem=True)
    assert c[0] - b[0] == 2 * 2 * (nx + 8) * (ny + 8) * item


def _read_at(source, field):
    """The index load_params reads a field at (ints and doubles)."""
    text = (cuda_build.CSRC / source).read_text()
    return [int(i) for i in re.findall(r"p\.%s = [id]p\[(\d+)\];" % field,
                                       text)]


def test_parameter_arrays_match_the_sources_offsets():
    """The CTU step's ints hold the spherical and problem flags, then the
    four domain-edge flags (ctu_step.cu's step_params), and its doubles
    end with e_rate; the MOL ones add the well-balanced flag, then rk's
    four domain-edge flags (mol_substep.cu's rk_params; zeros for fv4),
    and e_rate after their own constants (euler_common.cuh's
    load_params)."""
    assert _read_at("euler_common.cuh", "spherical") == [18]
    assert _read_at("euler_common.cuh", "problem") == [19]
    assert _read_at("euler_common.cuh", "well_balanced") == [20]
    assert _read_at("euler_common.cuh", "e_rate") == [19, 13]
    for k, edge in enumerate(("xl", "xr", "yl", "yr")):
        assert _read_at("ctu_step.cu", f"edge_{edge}") == [20 + k]
        assert _read_at("mol_substep.cu", f"edge_{edge}") == [21 + k]
    sim = _sim("compressible", "heating")
    U = sim.cc_data.data
    ints, doubles, S = sim._step.kernel_args(U, 0.0, 1e-4,
                                             energy_rate(sim, U)[0])
    assert len(ints) == 24 and len(doubles) == 14
    assert ints[11] == 1 and ints[18] == 0 and ints[19] == 1
    assert ints[20:] == [1, 1, 1, 1]
    assert doubles[13] == 0.1
    for solver, kind in (("compressible_rk", "rk"),
                         ("compressible_fv4", "fv4")):
        msim = _sim(solver, "heating")
        U = msim.cc_data.data
        e_rate, W = energy_rate(msim, U)
        ints, doubles = msim._step.kernel_args(U, 1e-4, e_rate)
        edges = [1, 1, 1, 1] if kind == "rk" else [0, 0, 0, 0]
        assert len(ints) == 25 and len(doubles) == 20, kind
        assert ints[18:] == [0, 1, 0, *edges] and doubles[19] == 0.1
        assert msim._step.spherical_lines(U) is None
        assert W.shape == U.shape[1:]


def test_ctu_args_carry_the_problem_source():
    """heating (grav 0) turns the sources on: S's energy row is the
    ghost-filled problem source of the floored state, W the cached weight
    plane, doubles[13] its e_rate; without the problem module's
    source_weight the launch refuses (A.27)."""
    sim = _sim("compressible", "heating")
    step = sim._step
    assert step.problem and step.with_sources and step.spherical is False
    U = sim.cc_data.data
    e_rate, W = energy_rate(sim, U)
    ints, doubles, S = step.kernel_args(U, 0.0, 1e-4, e_rate)
    e_rate, w = sim.problem_source_weight(sim.cc_data.grid, sim.rp)
    assert doubles[13] == e_rate == 0.1
    assert torch.equal(W, torch.as_tensor(w))
    assert W is energy_rate(sim, U)[1]
    src = sim.problem_source(sim.cc_data.grid, U, sim.ivars, sim.rp)
    g = sim.cc_data.grid
    sl = (slice(g.ilo, g.ihi + 1), slice(g.jlo, g.jhi + 1))
    assert torch.equal(S[3][sl], src[sim.ivars.iener][sl])
    assert not S[0].any()
    sim.problem_source_weight = None
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.27"):
        step.launch(U, 0.0, 1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nvar", range(4, ctu_kernel.MAXVAR + 1))
def test_mol_plans_of_the_extended_instantiation(dtype, nvar):
    """fv4's extended instantiation holds three centred source planes (xmom,
    ymom, ener) where the plain one holds two (rk's reads its new inputs
    from device memory and keeps its plan); it fits a block's opt-in
    limit."""
    item = torch.empty((), dtype=dtype).element_size()
    a = mol_kernel.plan(200, 136, nvar, dtype)
    b = mol_kernel.plan(200, 136, nvar, dtype, extended=True)
    assert a.sizes["sc"] == 2 * a.box("states")
    assert b.sizes["sc"] == 3 * b.box("states")
    assert b.smem - a.smem == b.box("states") * item
    assert b.smem <= SMEM_LIMIT
    end = 0
    for name in b.ARRAYS:
        assert b.offsets[name] == (end if b.sizes[name] else -1)
        end += b.sizes[name]
    assert end * item == b.smem


@pytest.mark.parametrize("kind", mol_kernel.KINDS)
def test_mol_work_counts_the_new_inputs(kind):
    nx, ny, item = 1024, 1000, 4
    qx, qy = nx + 8, ny + 8
    base = mol_kernel.work(kind, nx, ny, 4, torch.float32)
    extra = mol_kernel.FLOPS_PER_ZONE_EXTENDED[kind]
    sph = mol_kernel.work(kind, nx, ny, 4, torch.float32, spherical=True)
    assert sph[0] - base[0] == (4 * qx + 3 * qy) * item
    assert sph[1] - base[1] == extra["spherical"] * nx * ny
    prob = mol_kernel.work(kind, nx, ny, 4, torch.float32, problem=True)
    assert prob[0] - base[0] == qx * qy * item
    assert prob[1] - base[1] == extra["problem"] * nx * ny
    wb = mol_kernel.work(kind, nx, ny, 4, torch.float32, well_balanced=True)
    assert wb[0] == base[0]
    assert wb[1] - base[1] == extra["well_balanced"] * nx * ny


@pytest.mark.parametrize("solver", ["compressible_rk", "compressible_fv4"])
def test_mol_spherical_lines(solver):
    """The lines buffer the spherical stage reads: Ly, r, the node radius
    and r - dr over i, sin(theta) at the node, the centre and the centre
    below over j, from the grid's float64 arrays, made once per dtype."""
    sim = _sim(solver, "sedov", SPH)
    step = sim._step
    g = sim.cc_data.grid
    assert step.spherical and step.extended and not step.problem
    U = sim.cc_data.data
    ints, doubles = step.kernel_args(U, 1e-4)
    G = step.spherical_lines(U)
    edges = [1, 1, 1, 1] if solver == "compressible_rk" else [0, 0, 0, 0]
    assert ints[18:] == [1, 0, 0, *edges]
    assert energy_rate(sim, U) == (0.0, None)
    qx, qy = g.qx, g.qy
    want = np.concatenate([g.Ly[:, 0], g.x, g.xl, g.x - g.dx, np.sin(g.yl),
                           np.sin(g.y), np.sin(g.y - g.dy)])
    assert G.shape == (4 * qx + 3 * qy,)
    assert np.array_equal(G.numpy(), want)
    assert step.spherical_lines(U) is G
    assert step.spherical_lines(U.float()).dtype == torch.float32


def test_rk_well_balanced_flag():
    sim = _sim("compressible_rk", "hse", {
        "mesh.ny": 48, "compressible.well_balanced": 1,
        "compressible.limiter": 1})
    step = sim._step
    ints, _ = step.kernel_args(sim.cc_data.data, 1e-4)
    assert ints[18:] == [0, 0, 1, 1, 1, 1, 1]
    assert step.spherical_lines(sim.cc_data.data) is None
    assert step.extended
