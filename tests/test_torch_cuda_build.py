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
        assert [h.name for h in heads] == ["mg_ops.cuh"]


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
    # the operators' device code is shared: editing mg_ops.cuh renames the
    # V-cycle's and the sharded multigrid's libraries, and no other
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    names = sorted(p.name for p in csrc.glob("*.cu"))
    assert "mg_deep.cu" in names and len(names) == 6
    before = {n: cuda_build.library_path(csrc / n) for n in names}
    ops = csrc / "mg_ops.cuh"
    ops.write_text(ops.read_text() + "// edited\n")
    changed = sorted(n for n in names
                     if cuda_build.library_path(csrc / n) != before[n])
    assert changed == ["mg_deep.cu", "mg_vcycle.cu"]
