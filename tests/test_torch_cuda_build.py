"""The CUDA build key: a library is named by a hash of its source, the
local headers it includes and the nvcc flags, so editing any of them
rebuilds it.  Runs on the CPU: nothing is compiled."""

from pyro2_tpu_torch.util import cuda_build


def _write(path, text):
    path.write_text(text)
    return path


def test_header_edit_changes_library_path(tmp_path):
    src = _write(tmp_path / "k.cu",
                 '#include "a.cuh"\nint f() { return g(); }\n')
    _write(tmp_path / "a.cuh", '#pragma once\n#include "sub/b.cuh"\n'
           "int g() { return h(); }\n")
    (tmp_path / "sub").mkdir()
    b = _write(tmp_path / "sub" / "b.cuh", "int h() { return 1; }\n")

    assert [h.name for h in cuda_build.local_includes(src)] == \
        ["a.cuh", "b.cuh"]
    first = cuda_build.library_path(src)
    assert first.name.startswith("libk-") and first.suffix == ".so"
    assert cuda_build.library_path(src) == first        # deterministic

    b.write_text("int h() { return 2; }\n")              # a nested header
    second = cuda_build.library_path(src)
    assert second != first

    src.write_text(src.read_text() + "// edited\n")      # the source
    assert cuda_build.library_path(src) not in (first, second)


def test_system_includes_are_not_followed(tmp_path):
    src = _write(tmp_path / "k.cu", "#include <cuda_runtime.h>\n"
                 "#include <math.h>\nint f() { return 0; }\n")
    assert cuda_build.local_includes(src) == []
    cuda_build.library_path(src)


def test_port_sources_share_the_euler_header():
    for name in ("ctu_step.cu", "mol_substep.cu"):
        heads = cuda_build.local_includes(cuda_build.CSRC / name)
        assert [h.name for h in heads] == ["euler_common.cuh",
                                           "grid_common.cuh"]
    for name in ("swe_step.cu", "lm_interface.cu"):
        heads = cuda_build.local_includes(cuda_build.CSRC / name)
        assert [h.name for h in heads] == ["grid_common.cuh"]
    for name in ("mg_vcycle.cu", "mg_deep.cu"):
        heads = cuda_build.local_includes(cuda_build.CSRC / name)
        assert [h.name for h in heads] == ["mg_tiles.cuh", "mg_ops.cuh"]


def test_grid_header_is_in_every_stencil_build_key(tmp_path, monkeypatch):
    # a copy of the sources: editing the shared grid header renames the
    # CTU, MOL, swe and lm_atm libraries, and leaves the multigrid one alone
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    names = ("ctu_step.cu", "mol_substep.cu", "swe_step.cu",
             "lm_interface.cu", "mg_vcycle.cu", "mg_deep.cu")
    before = [cuda_build.library_path(csrc / n) for n in names]
    grid = csrc / "grid_common.cuh"
    grid.write_text(grid.read_text() + "// edited\n")
    after = [cuda_build.library_path(csrc / n) for n in names]
    assert [a != b for a, b in zip(after, before)] == [True] * 4 + [False] * 2


def test_multigrid_header_is_in_both_multigrid_build_keys(tmp_path):
    # the operators' and the tiles' device code is shared: editing
    # mg_ops.cuh or mg_tiles.cuh renames the V-cycle's and the sharded
    # multigrid's libraries, and no other
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    names = sorted(p.name for p in csrc.glob("*.cu"))
    assert "mg_deep.cu" in names and len(names) == 6
    for header in ("mg_ops.cuh", "mg_tiles.cuh"):
        before = {n: cuda_build.library_path(csrc / n) for n in names}
        head = csrc / header
        head.write_text(head.read_text() + "// edited\n")
        changed = sorted(n for n in names
                         if cuda_build.library_path(csrc / n) != before[n])
        assert changed == ["mg_deep.cu", "mg_vcycle.cu"], header


def _extern_params(source):
    """{entry: number of parameters} of a source's plain `extern "C"`
    functions (not those its macros expand)."""
    import re
    text = (cuda_build.CSRC / source).read_text()
    found = {}
    for m in re.finditer(r'^extern "C" [\w\s\*]+?\b(\w+)\(([^)]*)\)', text,
                         re.MULTILINE):
        params = [p for p in m.group(2).split(",") if p.strip()]
        found[m.group(1)] = len(params)
    return found


class _FakeFn:
    def __init__(self, ret):
        self.ret = ret
        self.argtypes = None

    def __call__(self, *args):
        return self.ret


class _FakeLib:
    """A stand-in for a CDLL: records each entry's argtypes."""

    def __init__(self, returns):
        self._returns = returns
        self._fns = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self._fns.setdefault(name,
                                    _FakeFn(self._returns.get(name, 0)))


def _bind(module, monkeypatch, returns=None):
    """Run a kernel module's _load against a fake library."""
    fake = _FakeLib(returns or {})
    monkeypatch.setattr(module, "_lib", None)
    monkeypatch.setattr(module, "build", lambda verbose=False: ("x", 0, ""))
    monkeypatch.setattr(module.ctypes, "CDLL", lambda path: fake)
    module._load()
    return fake._fns


def test_ctu_entries_match_their_bindings(monkeypatch):
    """ctu_step.cu exports one step entry per dtype, one device-dt step
    entry per dtype (the step's nine and the dt pointer), one batched
    entry per dtype and one batched stage-prefix entry per dtype (the
    batched entry's seven and the stages), each taking the launch plan,
    and the plan's length,
    which is ctu_kernel.plan's; no scratch-size entry is left (the step
    keeps its intermediates on the chip).  The ctypes bindings give each
    entry its parameter count."""
    import re

    import torch

    from pyro2_tpu_torch.solvers.compressible import ctu_kernel

    entries = _extern_params("ctu_step.cu")
    assert entries == {"ctu_plan_ints": 0, "ctu_step_f32": 9,
                       "ctu_step_f64": 9, "ctu_step_dev_f32": 10,
                       "ctu_step_dev_f64": 10, "ctu_step_batched_f32": 7,
                       "ctu_step_batched_f64": 7, "ctu_stage_batched_f32": 8,
                       "ctu_stage_batched_f64": 8}
    text = (cuda_build.CSRC / "ctu_step.cu").read_text()
    assert "scratch" not in text.split("namespace {", 1)[1]
    plan_ints = int(re.search(r"constexpr int PLAN_INTS = (\d+);",
                              text).group(1))
    for dtype in (torch.float32, torch.float64):
        assert len(ctu_kernel.plan(8, 8, 4, dtype).ints()) == plan_ints
    fns = _bind(ctu_kernel, monkeypatch, {"ctu_plan_ints": plan_ints})
    for name, n in entries.items():
        if n:
            assert len(fns[name].argtypes) == n, name
    assert "ctu_scratch_planes" not in fns


def test_core_entries_take_the_schedule(monkeypatch):
    """Every multigrid core entry takes its schedule (the warps of each
    level, the cluster's CTAs and its first spread level) after its alpha
    and beta; the down and up entries take a tile plan there instead; the
    core's shared-memory layout is Python's (mg_kernel.core_offsets, in the
    schedule), not an entry."""
    from pyro2_tpu_torch.multigrid import mg_kernel

    text = (cuda_build.CSRC / "mg_vcycle.cu").read_text()
    assert "mg_core_smem" not in text
    # the core template and the two entry macros (constant, coefficient)
    assert text.count("const double* ab, const int* schedule,") == 3
    fns = _bind(mg_kernel, monkeypatch)
    for sfx, ncoef in mg_kernel.FLAVOURS.values():
        for t in ("f32", "f64"):
            core = fns[f"mg_core{sfx}_{t}"].argtypes
            assert len(core) == 4 + 3 + 4 + (1 if ncoef else 0) + 1
            assert len(fns[f"mg_down{sfx}_{t}"].argtypes) == \
                5 + 2 + 4 + (1 if ncoef else 0) + 1
    assert "mg_core_smem" not in fns


def test_mol_entries_match_their_bindings(monkeypatch):
    """mol_substep.cu's rk and fv4 entries take their launch plans and no
    scratch, and the plans' lengths are mol_kernel.rk_plan's and plan's
    (RK_PLAN_INTS, FV4_PLAN_INTS); the scratch-size entry is gone, and each
    entry launches one kernel (k_rk, k_fv4).  The ctypes bindings give each
    entry its parameter count."""
    import re

    import torch

    from pyro2_tpu_torch.solvers.compressible_fv4 import mol_kernel

    entries = _extern_params("mol_substep.cu")
    assert entries == {"mol_rk_plan_ints": 0, "mol_fv4_plan_ints": 0,
                       "mol_rk_substep_f32": 8, "mol_rk_substep_f64": 8,
                       "mol_fv4_substep_f32": 8, "mol_fv4_substep_f64": 8}
    text = (cuda_build.CSRC / "mol_substep.cu").read_text()
    for kind in ("rk", "fv4"):
        for t in ("f32", "f64"):
            sig = re.search(r"mol_%s_substep_%s\(([^)]*)\)" % (kind, t),
                            text).group(1)
            assert "scratch" not in sig and "plan" in sig
    body = text.split("namespace {", 1)[1]
    assert "scratch" not in body.replace("there is no scratch", "")
    assert "mol_scratch_planes" not in text
    assert sorted(re.findall(r"(\w+)<<<", body)) == ["kernel", "kernel"]
    assert re.findall(r"__global__.*?\b(k_\w+)\(", body, re.DOTALL) == \
        ["k_fv4", "k_rk"]
    n_ints = {kind: int(re.search(r"constexpr int %s_PLAN_INTS = (\d+);" %
                                  kind.upper(), text).group(1))
              for kind in ("rk", "fv4")}
    for dtype in (torch.float32, torch.float64):
        assert len(mol_kernel.rk_plan(8, 8, 4, dtype).ints()) == n_ints["rk"]
        assert len(mol_kernel.plan(8, 8, 4, dtype).ints()) == n_ints["fv4"]
    fns = _bind(mol_kernel, monkeypatch,
                {f"mol_{k}_plan_ints": n for k, n in n_ints.items()})
    for name, n in entries.items():
        if n:
            assert len(fns[name].argtypes) == n, name
    assert "mol_scratch_planes" not in fns


def test_up_entries_take_the_plan_and_no_grid_barrier(monkeypatch):
    """Every mg_up entry takes a scratch frame for its rounds after r and
    its plan after alpha and beta; k_up is an ordinary launch (no
    cooperative launch, no grid group), as every kernel of the file is;
    the plan's length is mg_kernel.tile_plan's (TILE_PLAN_INTS)."""
    import re

    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    text = (cuda_build.CSRC / "mg_vcycle.cu").read_text()
    # the up template and the two entry macros (constant, coefficient)
    assert len(re.findall(r"int up\(.*T\* r, T\* scratch,", text)) == 1
    assert len(re.findall(r"mg_up_##[\w#]*\([^)]*T\* r, T\* scratch,", text,
                          re.DOTALL)) == 2
    body = text.split("k_up(TileArgs<T> a) {", 1)[1].split("\n}\n", 1)[0]
    assert "grid" not in body and "sync()" not in body
    for gone in ("cudaLaunchCooperativeKernel", "launch_cooperative",
                 "grid_group", "this_grid", "grid.sync"):
        assert gone not in text, gone
    assert "tiled<T>(k_up<OP, T>," in text
    n_ints = int(re.search(r"constexpr int TILE_PLAN_INTS = (\d+);",
                           text).group(1))
    assert len(mg_kernel.tile_plan(64, 10, torch.float32).ints()) == n_ints
    fns = _bind(mg_kernel, monkeypatch, {"mg_tile_plan_ints": n_ints})
    for sfx, ncoef in mg_kernel.FLAVOURS.values():
        for t in ("f32", "f64"):
            assert len(fns[f"mg_up{sfx}_{t}"].argtypes) == \
                6 + 2 + 4 + (1 if ncoef else 0) + 1


def test_down_entries_take_the_plan_and_no_grid_barrier(monkeypatch):
    """Every mg_down entry takes a scratch frame for its rounds after fc
    and its tile plan after alpha and beta (the plan's length is
    mg_kernel.tile_plan's); k_down is an ordinary launch, one per round,
    with block barriers only; the cooperative first design's helpers are
    gone, and cooperative_groups stays for the core's cluster alone."""
    import re

    import torch

    from pyro2_tpu_torch.multigrid import mg_kernel

    text = (cuda_build.CSRC / "mg_vcycle.cu").read_text()
    assert re.search(r"int down\(const T\* v, const T\* f, T\* vo, T\* fc, "
                     r"T\* scratch, int n,", text)
    assert len(re.findall(r"mg_down_##[\w#]*\([^)]*T\* fc,[\s\\]*T\* scratch, "
                          r"int n, int nsmooth,[^)]*const int\* plan,", text,
                          re.DOTALL)) == 2
    body = text.split("k_down(TileArgs<T> a) {", 1)[1].split("\n}\n", 1)[0]
    assert "grid" not in body.replace("gridDim", "") and "sync()" not in body
    assert "tile_smooth<OP>(b, fb, t, L, 2 * a.iters, 0, AllCells{});" in body
    # the constant operator's 64^2 tiles: the register-resident overload
    regs = text.split("k_down(RegArgs<T> r) {", 1)[1].split("\n}\n", 1)[0]
    assert "down_regs(" in regs
    body = text.split("void down_regs(", 1)[1].split("\n}\n", 1)[0]
    assert "grid" not in body.replace("gridDim", "") and "sync()" not in body
    assert "reg_smooth<OP>(c, b, t, L, o, 2 * a.iters);" in body
    assert "tiled<T>(k_down<OP, T>," in text
    for gone in ("colored(", "coop_blocks", "void smooth("):
        assert gone not in text, gone
    assert "cg::this_cluster()" in text
    plan = mg_kernel.tile_plan(1024, 10, torch.float32)
    assert len(plan.ints()) == len(mg_kernel.TilePlan.FIELDS)
    fns = _bind(mg_kernel, monkeypatch, {"mg_tile_plan_ints": 8})
    for sfx, ncoef in mg_kernel.FLAVOURS.values():
        for t in ("f32", "f64"):
            assert len(fns[f"mg_down{sfx}_{t}"].argtypes) == \
                5 + 2 + 4 + (1 if ncoef else 0) + 1


def test_swe_entries_take_the_plan_and_no_scratch(monkeypatch):
    """swe_step.cu exports a host-dt and a device-dt step entry per
    dtype (the latter with dt's device pointer before the stream), each
    taking the launch plan and no scratch, and the plan's length, which is
    swe_kernel.plan's; no scratch-size entry is left (the step keeps its
    intermediates on the chip), and one kernel (k_swe) is launched a
    step."""
    import re

    import torch

    from pyro2_tpu_torch.solvers.swe import swe_kernel

    entries = _extern_params("swe_step.cu")
    assert entries == {"swe_plan_ints": 0, "swe_step_f32": 6,
                       "swe_step_f64": 6, "swe_step_dev_f32": 7,
                       "swe_step_dev_f64": 7}
    text = (cuda_build.CSRC / "swe_step.cu").read_text()
    body = text.split("namespace {", 1)[1]
    assert "scratch" not in body
    assert len(re.findall(r"<<<", body)) == 1 and "kernel<<<" in body
    assert len(re.findall(r"__global__", body)) == 1
    plan_ints = int(re.search(r"constexpr int PLAN_INTS = (\d+);",
                              text).group(1))
    for dtype in (torch.float32, torch.float64):
        assert len(swe_kernel.plan(8, 8, 4, dtype).ints()) == plan_ints
    fns = _bind(swe_kernel, monkeypatch, {"swe_plan_ints": plan_ints})
    for name, n in entries.items():
        if n:
            assert len(fns[name].argtypes) == n, name
    assert "swe_scratch_planes" not in fns


def test_deep_entries_take_the_plan_and_no_grid_barrier(monkeypatch):
    """mg_deep.cu's smoothing entries take the tile plan after alpha and
    beta (its length is sharded_mg_kernel.deep_plan's, DEEP_PLAN_INTS);
    k_deep is ordinary launches with block barriers only -- no cooperative
    launch, grid group or grid barrier is left -- and takes its boxes,
    load, sweeps and neighbours from mg_tiles.cuh, as mg_vcycle.cu's k_down
    and k_up take their boxes, load, sweeps and register-resident smoother:
    the tile code is defined there alone."""
    import re

    import torch

    from pyro2_tpu_torch.multigrid import sharded_mg_kernel as smk

    text = (cuda_build.CSRC / "mg_deep.cu").read_text()
    for gone in ("cudaLaunchCooperativeKernel", "cooperative_groups",
                 "grid_group", "this_grid", "sync()", "coop_blocks"):
        assert gone not in text, gone
    assert re.search(r"const double\* coef, const double\* ab, "
                     r"const int\* tiles,", text)
    n_ints = int(re.search(r"constexpr int DEEP_PLAN_INTS = (\d+);",
                           text).group(1))
    for smoother in smk.SMOOTHERS:
        plan = smk.deep_plan(64, 32, 1, 21, 10, smoother, torch.float32)
        assert len(plan.ints()) == n_ints
    tiles = (cuda_build.CSRC / "mg_tiles.cuh").read_text()
    vcycle = (cuda_build.CSRC / "mg_vcycle.cu").read_text()
    for name in ("struct BoxAxis", "struct LevelBox", "struct FrameBox",
                 "struct Nbrs", "void load_box(", "void tile_smooth(",
                 "T* round_dst(", "struct RegCells", "void reg_load(",
                 "void reg_smooth("):
        assert name in tiles and name not in text and name not in vcycle
    for source in (text, vcycle):
        assert "tile_smooth<OP>(" in source and "load_box(" in source
    assert "reg_smooth<OP>(" in vcycle and "reg_load(" in vcycle
    fns = _bind(smk, monkeypatch, {"mg_deep_plan_ints": n_ints})
    for t in ("f32", "f64"):
        assert len(fns[f"mg_deep_smooth_{t}"].argtypes) == \
            7 + 1 + 3 + 3 + 2 + 1 + 1
        assert len(fns[f"mg_correct_{t}"].argtypes) == 3 + 2 + 1


def test_lm_entries_take_the_plan_and_no_scratch(monkeypatch):
    """lm_interface.cu's entries (lm_mac, lm_states, lm_rho for each dtype,
    from its ENTRIES macro) take the launch plan and no scratch, and the
    plan's length is lm_kernel.plan's (LM_PLAN_INTS); each entry launches
    one kernel (k_lm_mac, k_lm_states, k_lm_rho) and the first design's
    first-pass kernels (k_lm_hat, k_lm_rho_hat) are gone.  The ctypes
    bindings give each entry its parameter count."""
    import re

    import torch

    from pyro2_tpu_torch.solvers.lm_atm import lm_kernel

    assert _extern_params("lm_interface.cu") == {"lm_plan_ints": 0}
    text = (cuda_build.CSRC / "lm_interface.cu").read_text()
    params = {}
    for name in ("mac", "states", "rho"):
        sig = re.search(r"lm_%s_##SFX\(([^)]*)\)" % name, text).group(1)
        params[name] = [p.strip() for p in sig.replace("\\", "").split(",")]
        assert not any("scratch" in p for p in params[name])
        assert params[name][-2:] == ["const int* plan", "void* stream"]
    assert {n: len(p) for n, p in params.items()} == \
        {"mac": 7, "states": 7, "rho": 6}
    body = text.split("namespace {", 1)[1]
    assert "scratch" not in body
    # one launch site, which each entry hands its one kernel
    assert len(re.findall(r"<<<", body)) == 1 and "kernel<<<" in body
    for name in ("k_lm_mac", "k_lm_states", "k_lm_rho"):
        assert len(re.findall(r"plan, %s<T>, st," % name, body)) == 1, name
    assert sorted(re.findall(r"__global__.*?\b(k_\w+)\(", body,
                             re.DOTALL)) == \
        ["k_lm_mac", "k_lm_rho", "k_lm_states"]
    assert "k_lm_hat" not in text and "k_lm_rho_hat" not in text
    n_ints = int(re.search(r"constexpr int LM_PLAN_INTS = (\d+);",
                           text).group(1))
    for dtype in (torch.float32, torch.float64):
        for entry in lm_kernel.ENTRIES:
            assert len(lm_kernel.plan(entry, 8, 8, 4, dtype).ints()) == \
                n_ints
    fns = _bind(lm_kernel, monkeypatch, {"lm_plan_ints": n_ints})
    for t in ("f32", "f64"):
        for name, n in params.items():
            assert len(fns[f"lm_{name}_{t}"].argtypes) == len(n), name


def test_edge_kinds_match_the_kernels():
    """mg_vcycle.cu's edge kinds are mg_kernel's (BC_KIND's values and
    ZERO), a ZERO edge's sign is 0, and every ghost the kernels write goes
    through `mirror`, which for the constant operator writes +0.0 on a
    ZERO edge (mg_tiles.cuh's sweeps read across an edge as the product,
    unchanged)."""
    import re

    from pyro2_tpu_torch.multigrid import mg_kernel

    text = (cuda_build.CSRC / "mg_vcycle.cu").read_text()
    enum = re.search(r"enum \{([^}]*)\};", text).group(1)
    kinds = {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", enum)}
    assert kinds == {"COPY": 0, "NEGATE": 1, "PERIODIC": 2,
                     "ZERO": mg_kernel.ZERO}
    assert set(mg_kernel.BC_KIND.values()) == {0, 1, 2}
    assert "kind == NEGATE ? T(-1) : kind == ZERO ? T(0) : T(1)" in text
    assert "if constexpr (OP == OP_CONST) {" in text
    assert "return g == T(0) ? T(0) : g * val;" in text
    # every store into a ghost row or column of a frame
    stores = re.findall(r"v\[[^\]]*\] =\s*([^;]*L\.g[xy][lh][^;]*);", text)
    assert len(stores) == 20
    assert all(x.startswith(("gh(", "mirror<OP>(")) for x in stores), stores
