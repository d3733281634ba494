"""The benchmark's frozen yardstick (benchmark/work/) equals the program's
own least-work functions at the benchmark's sizes, so a roofline share
means the same to the benchmark as to the program's kernel checks."""

import types

import pytest
import torch

from work import ctu, mg, roofline

from pyro2_tpu_torch.multigrid import mg_kernel
from pyro2_tpu_torch.solvers.compressible import ctu_kernel

SIZES = (1024, 4096)
DTYPES = ("float32", "float64")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", [{}, {"with_sources": True},
                                {"spherical": True}, {"problem": True},
                                {"stages": 2}, {"n_members": 3}])
def test_ctu_work_equals_the_program(n, dtype, kw):
    assert ctu.work(n, n, 4, dtype, **kw) == \
        ctu_kernel.work(n, n, 4, getattr(torch, dtype), **kw)


def test_ctu_counts_equal_the_program():
    assert ctu.FLOPS_PER_ZONE == ctu_kernel.FLOPS_PER_ZONE
    assert ctu.FLOPS_PER_ZONE_PREFIX == ctu_kernel.FLOPS_PER_ZONE_PREFIX
    assert ctu.FLOPS_PER_ZONE_SPHERICAL == \
        ctu_kernel.FLOPS_PER_ZONE_SPHERICAL
    assert ctu.FLOPS_PER_ZONE_PROBLEM == ctu_kernel.FLOPS_PER_ZONE_PROBLEM


@pytest.mark.parametrize("n", SIZES + (64, 128))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("entry", sorted(mg_kernel.launches))
@pytest.mark.parametrize("guess", [True, False])
def test_mg_work_equals_the_program(n, dtype, entry, guess):
    for want_r in (True, False):
        assert mg.work(entry, n, mg.NSMOOTH, dtype, with_guess=guess,
                       want_r=want_r) == \
            mg_kernel.work(entry, n, mg.NSMOOTH, getattr(torch, dtype),
                           nsmooth_bottom=mg.NSMOOTH_BOTTOM,
                           with_guess=guess, want_r=want_r)


def test_mg_counts_equal_the_program():
    assert mg.FLOPS_GS == mg_kernel.FLOPS_GS
    assert mg.FLOPS_RESID == mg_kernel.FLOPS_RESID
    assert (mg.FLOPS_RESTRICT, mg.FLOPS_PROLONG) == \
        (mg_kernel.FLOPS_RESTRICT, mg_kernel.FLOPS_PROLONG)
    assert mg.CORE_MAX == {str(k).split(".")[-1]: v
                           for k, v in mg_kernel.CORE_MAX.items()}
    assert mg.NCOEF == {k: v[1] for k, v in mg_kernel.FLAVOURS.items()}


def test_mg_smoothing_equals_the_solver():
    from pyro2_tpu_torch.multigrid.MG import CellCenterMG2d

    m = CellCenterMG2d(16, 16, device="cpu")
    assert (m.nsmooth, m.nsmooth_bottom) == (mg.NSMOOTH, mg.NSMOOTH_BOTTOM)


@pytest.mark.parametrize("n", SIZES + (64, 128, 256))
@pytest.mark.parametrize("dtype", DTYPES)
def test_cycle_launches_equal_the_program(n, dtype, monkeypatch):
    """The launches of one finest-level cycle as mg_kernel._cycle makes
    them, recorded through stand-ins of its three entries."""
    made = []

    def down(m, level, v, f):
        made.append(("mg_down", 2 ** (level + 1), v is not None, True))
        return "v", f

    def core(m, top, v, f, want_r):
        made.append(("mg_core", 2 ** (top + 1), v is not None, want_r))
        return "v", "r"

    def up(m, level, v, f, vc, want_r):
        made.append(("mg_up", 2 ** (level + 1), True, want_r))
        return "v", "r"

    for name, fn in (("down", down), ("core", core), ("up", up)):
        monkeypatch.setattr(mg_kernel, name, fn)
    nlevels = n.bit_length() - 1
    fake = types.SimpleNamespace(nlevels=nlevels)
    f = torch.zeros(1, dtype=getattr(torch, dtype))
    mg_kernel._cycle(fake, torch.zeros(1, dtype=f.dtype), f)
    assert made == mg.cycle_launches(n, dtype)
    assert mg.split(nlevels, dtype) == mg_kernel.split(fake, f.dtype)


def test_roofline_bound():
    assert roofline.bound_s(3.35e12, 0, "float32") == 1.0
    assert roofline.bound_s(0, 66.9e12, "float32") == 1.0
    assert roofline.bound_s(0, 34.0e12, "float64") == 1.0
    assert roofline.share_pct(1.0, 4.0) == 25.0
    assert roofline.share_pct(1.0, 0.0) is None
