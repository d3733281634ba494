"""Build the port's CUDA sources with nvcc into shared libraries.

Every kernel source under pyro2_tpu_torch/csrc has a plain C interface and
is bound with ctypes.  `build(source)` compiles it for sm_90a into
pyro2_tpu_torch/_build/lib<stem>-<key>.so at first use, where <key> hashes
the source, every local header it includes (`#include "..."`, followed
recursively) and the flags, so an edited source or header is rebuilt.
`build_many` starts one nvcc per source, all together, and waits for them.
"""

import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "MAXVAR", "NVCC_FLAGS", "build",
           "build_many", "library_path", "local_includes"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# the most variables a state stack may hold in the kernels (MAXVAR of
# csrc/grid_common.cuh, the length of their per-cell arrays)
MAXVAR = 8
# -fmad=false keeps each multiply and add rounded on its own, as the plain
# PyTorch versions round them
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_includes(source):
    """Every header a source includes with `#include "..."`, resolved
    against the including file's directory and followed recursively, in
    the order first met."""
    found = []
    todo = [Path(source).resolve()]
    while todo:
        f = todo.pop(0)
        for name in _INCLUDE.findall(f.read_bytes()):
            h = (f.parent / name.decode()).resolve()
            if h not in found:
                found.append(h)
                todo.append(h)
    return found


def library_path(source):
    """The library a source builds into: lib<stem>-<hash>.so, the hash
    over the source, its local headers and the flags."""
    source = Path(source)
    h = hashlib.sha256(source.read_bytes())
    for header in local_includes(source):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def _start(source, verbose):
    """(library path, running nvcc or None when the library exists)."""
    so = library_path(source)
    if so.exists() and not verbose:
        return so, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return so, (proc, tmp)


def build_many(sources, verbose=False):
    """Compile every source whose library is not built yet, one nvcc each,
    all started together.

    Returns one (library path, seconds spent in nvcc, nvcc's stderr) per
    source.  With verbose=True every source is compiled and ptxas reports
    registers, shared memory and spills."""
    t0 = time.perf_counter()
    started = [_start(Path(s), verbose) for s in sources]
    out = []
    for so, job in started:
        if job is None:
            out.append((so, 0.0, ""))
            continue
        proc, tmp = job
        _, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {so.name} ({proc.returncode}):\n{stderr}")
        os.replace(tmp, so)
        out.append((so, seconds, stderr))
    return out


def build(source, verbose=False):
    """Compile one source (if its library is not built yet); returns
    (library path, seconds spent in nvcc, nvcc's stderr)."""
    return build_many([source], verbose)[0]
