"""Programs that the sharded tests of the PyTorch port run on every rank of
a gloo mesh (pyro2_tpu_torch.parallel.launch.run).

They import torch and pyro2_tpu_torch only, never JAX: a rank unpickles
its program by importing this module.  The tests compute the JAX side in
their own process and compare.  Each program takes plain numpy inputs and
returns numpy results (launch.run converts tensors).
"""

import time

import numpy as np
import torch

import pyro2_tpu_torch.mesh.boundary as bnd
from pyro2_tpu_torch.mesh import patch
from pyro2_tpu_torch.mesh.grid import Grid2d
from pyro2_tpu_torch.parallel import blocks, mesh_comm, sharded_mg
from pyro2_tpu_torch.parallel.sharded_diffusion import ShardedDiffusion
from pyro2_tpu_torch.util.carry import carry_block
from pyro2_tpu_torch.util.runparams import RuntimeParameters

F64 = torch.float64


def _bc(kinds):
    return bnd.BC(xlb=kinds[0], xrb=kinds[1], ylb=kinds[2], yrb=kinds[3])


def _rp(params):
    rp = RuntimeParameters()
    rp.params = dict(params)
    rp.param_comments = {k: "" for k in rp.params}
    return rp


def exchanges(mesh, interior, cases, deep_cases):
    """Every exchange of mesh_comm on this rank's block of `interior`:
    {name: result} for halo_exchange, gated_physical_fill and seam_exchange
    (cases: (name, BC kinds, ng)) and deep_pad_exchange / deep_phys_refresh
    (deep_cases: (name, BC kinds, dpx, dpy))."""
    out = {}
    blk = carry_block(interior, mesh)
    nx, ny = interior.shape
    for name, kinds, ng in cases:
        bc = _bc(kinds)
        lg = Grid2d(nx // mesh.px, ny // mesh.py, ng=ng)
        pad = torch.nn.functional.pad(blk, (ng, ng, ng, ng))
        out["halo_" + name] = mesh_comm.halo_exchange(pad, lg, bc, mesh)
        # a padded block whose ghosts hold pointwise values of their own
        filled = pad.clone()
        filled[:ng] += 7.0
        filled[-ng:] -= 3.0
        filled[:, :ng] += 5.0
        out["gated_" + name] = mesh_comm.gated_physical_fill(filled, lg, bc,
                                                             mesh)
        out["seam_" + name] = mesh_comm.seam_exchange(filled, lg, mesh)
    for name, kinds, dpx, dpy in deep_cases:
        bc = _bc(kinds)
        for phys in (True, False):
            out[f"deep_{name}_{phys}"] = mesh_comm.deep_pad_exchange(
                blk, bc, mesh, dpx, dpy, phys=phys)
        bare = mesh_comm.deep_pad_exchange(blk, bc, mesh, dpx, dpy,
                                           phys=False)
        out[f"refresh_{name}"] = mesh_comm.deep_phys_refresh(bare, bc, mesh,
                                                             dpx, dpy)
    out["coords"] = np.array([mesh.ix, mesh.iy])
    out["psum"] = mesh.psum(torch.tensor([1.0, float(mesh.ix), float(mesh.iy)],
                                         dtype=F64))
    out["gather"] = mesh.all_gather("y", mesh.all_gather("x", blk, 0), 1)
    return out


def blockwise_init(mesh, params, problem):
    """This rank's blockwise initial interior of an incompressible
    problem."""
    import importlib

    from pyro2_tpu_torch.solvers import incompressible

    problem_mod = importlib.import_module(
        f"pyro2_tpu_torch.solvers.incompressible.problems.{problem}")
    rp = _rp(params)
    # the contract (names, aux, grid type) of a Simulation's data
    sim = incompressible.Simulation("incompressible", problem,
                                    problem_mod.init_data, _rp(params),
                                    device="cpu")
    sim.initialize()
    return blocks.blockwise_init_interior(sim.cc_data, problem_mod.init_data,
                                          rp, mesh)


def _general_coeffs(g, planes, kinds):
    d = patch.CellCenterData2d(g, dtype=F64, device="cpu")
    bc = _bc(kinds)
    for name in ("alpha", "beta", "gamma_x", "gamma_y"):
        d.register_var(name, bc)
    d.create()
    for name in ("alpha", "beta", "gamma_x", "gamma_y"):
        d.set_var(name, planes[name])
    return d


def make_mg(mesh, case):
    """A sharded MG of one test case: {"op": "const" / "vc" / "general",
    "n", "kw" (constructor keywords), "eta" and "coeffs_bc" (vc), "planes"
    and "coeffs_bc" (general)}."""
    n, kw = case["n"], dict(case["kw"])
    if case["op"] == "const":
        return sharded_mg.ShardedMG(n, n, mesh, **kw)
    if case["op"] == "vc":
        return sharded_mg.ShardedVarCoeffMG(
            n, n, mesh, coeffs=case["eta"], coeffs_bc=_bc(case["coeffs_bc"]),
            **kw)
    g = Grid2d(n, n, ng=1)
    return sharded_mg.ShardedGeneralMG(
        n, n, mesh, coeffs=_general_coeffs(g, case["planes"],
                                           case["coeffs_bc"]), **kw)


def mg_solves(mesh, cases):
    """One solve of each case from a zero guess: this rank's block, the
    gathered solution (rank 0), the cycle count, the errors and the source
    norm, and how much of the solve's time was spent."""
    out = []
    for case in cases:
        t0 = time.perf_counter()
        mg = make_mg(mesh, case)
        mg.init_zeros()
        mg.init_RHS(case["f"])
        mg.solve(rtol=case.get("rtol", 1e-11))
        gathered = mg.gather_solution()          # collective
        out.append({"block": mg.get_solution(),
                    "gathered": gathered if mesh.ix == mesh.iy == 0 else None,
                    "cycles": mg.num_cycles,
                    "residual_error": mg.residual_error,
                    "relative_error": mg.relative_error,
                    "source_norm": mg.source_norm,
                    "k_cross": mg.k_cross,
                    "seconds": time.perf_counter() - t0})
    return out


def gradient(mesh, case, v):
    """get_solution_gradient_interior of this rank's block of the global
    interior v."""
    mg = make_mg(mesh, case)
    mg.init_solution(v)
    return mg.get_solution_gradient_interior()


def deep_ghosts(mesh, case, level):
    """_deep_smooth of an empty sweep schedule (nsmooth_speed = 0) at one
    level against the halo exchange of the same block: both one-ghost
    blocks."""
    mg = make_mg(mesh, case)
    geom = mg._deep_geom[level]
    lg = mg.local_grids[level]
    rng = np.random.default_rng(mesh.ix * 10 + mesh.iy)
    v = torch.nn.functional.pad(torch.as_tensor(
        rng.standard_normal((lg.nx, lg.ny))), (1, 1, 1, 1))
    f = torch.as_tensor(rng.standard_normal((lg.nx + 2, lg.ny + 2)))
    got, _ = mg._deep_smooth(level, v, mg._deep_rhs(level, f, geom), geom)
    return {"deep": got, "halo": mg._ops._fill_v(level, v),
            "sweeps": geom["sweeps_j"]}


def diffusion(mesh, params, steps):
    """ShardedDiffusion: this rank's phi block after `steps` steps and the
    gathered phi (rank 0), with the cycle count of every solve."""
    sd = ShardedDiffusion(_rp(params), mesh, problem="gaussian", dtype=F64)
    cycles = []
    for _ in range(steps):
        sd.evolve()
        cycles.append(sd.smg.num_cycles)
    gathered = sd.gather_phi()                   # collective
    return {"block": sd.get_phi(), "cycles": cycles, "dt": sd.dt,
            "gathered": gathered if mesh.ix == mesh.iy == 0 else None}


def several(mesh, jobs):
    """[program(mesh, *args) for each (name of a program here, args)]: one
    launch for many programs."""
    return [globals()[name](mesh, *args) for name, args in jobs]


def never_sends(mesh):
    """Rank 0 waits for a message that rank 1 never sends."""
    buf = torch.zeros(4)
    if mesh.ix == 0 and mesh.iy == 0:
        torch.distributed.recv(buf, src=1)
    else:
        time.sleep(3600)
    return buf


def raises(mesh):
    """Rank 1 fails; rank 0 finishes."""
    if mesh.index("y") == 1:
        raise ValueError("rank 1 fails on purpose")
    return mesh.index("y")


def refined_solve(mesh, n, f):
    """A float32 ShardedMG's direct solve at rtol 1e-10 and then its
    solve_ir_sharded from a zero guess: the residual errors, the passes,
    and this rank's hi and lo blocks."""
    from pyro2_tpu_torch.multigrid.refine import solve_ir_sharded

    smg = sharded_mg.ShardedMG(n, n, mesh, dtype=torch.float32)
    smg.init_zeros()
    smg.init_RHS(f)
    smg.solve(rtol=1e-10)
    direct = smg.residual_error
    smg.init_zeros()
    smg.init_RHS(f)
    res, passes = solve_ir_sharded(smg, rtol=1e-10)
    return {"direct": direct, "refined": res, "passes": passes,
            "hi": smg.v_int, "lo": smg.v_lo,
            "source_norm": smg.source_norm, "f": smg.f_int}
