"""The least work of the multigrid kernels (k_down, k_up, k_core), frozen.

A copy of pyro2_tpu_torch/multigrid/mg_kernel.py's operation counts,
`work`, `CORE_MAX` and `split`, as they stood when the benchmark was
written, and the launches of one V-cycle as `mg_kernel._cycle` makes
them.  `benchmark/tests/` holds the copy equal to the program's
functions at the benchmark's sizes.
"""

import math

# coefficient planes of each operator
NCOEF = {"const": 0, "vc": 2, "general": 5}
# floating-point operations, counted from mg_vcycle.cu (+, -, *, / and a
# negation each one), by operator
FLOPS_GS = {"const": 7, "vc": 13, "general": 17}
FLOPS_RESID = {"const": 13, "vc": 12, "general": 20}
FLOPS_RESTRICT = 4
FLOPS_PROLONG = 9
# the finest level the core kernel holds, by dtype
CORE_MAX = {"float32": 128, "float64": 64}
# the smoothing of CellCenterMG2d: sweeps a level, sweeps at the bottom
NSMOOTH, NSMOOTH_BOTTOM = 10, 50

ITEMSIZE = {"float32": 4, "float64": 8}
_OPS = {"": "const", "vc": "vc", "general": "general"}


def work(entry, n, nsmooth, dtype, *, nsmooth_bottom=NSMOOTH_BOTTOM,
         with_guess=True, want_r=True):
    """(bytes, operations) one call of `entry` (mg_down, mg_up_vc,
    mg_core_general, ...) must move and do at least, for a level of n^2
    interior cells (the core's top level for a core entry): each input
    frame and coefficient plane read once and each output frame written
    once, and the operations of the sweeps, residuals and transfers."""
    kind, _, sfx = entry.partition("_")[2].partition("_")
    op = _OPS.get(sfx)
    if not entry.startswith("mg_") or op is None:
        raise ValueError(f"unknown entry {entry}")
    ncoef = NCOEF[op]
    gs, res = FLOPS_GS[op], FLOPS_RESID[op]
    item = ITEMSIZE[dtype]
    q2 = (n + 2) ** 2
    qc2 = (n // 2 + 2) ** 2
    if kind == "down":
        frames = (2 if with_guess else 1) * q2 + q2 + qc2 + ncoef * q2
        ops = (gs * nsmooth + res) * n * n + FLOPS_RESTRICT * (n // 2) ** 2
    elif kind == "up":
        frames = 3 * q2 + qc2 + (q2 if want_r else 0) + ncoef * q2
        ops = (FLOPS_PROLONG + gs * nsmooth + (res if want_r else 0)) * n * n
    elif kind == "core":
        frames = (2 if with_guess else 1) * q2 + q2 + (q2 if want_r else 0)
        ops = gs * nsmooth_bottom * 4 + (res * n * n if want_r else 0)
        m = n
        while m > 2:
            ops += (2 * gs * nsmooth + res + FLOPS_PROLONG) * m * m + \
                FLOPS_RESTRICT * (m // 2) ** 2
            m //= 2
        m = n
        while m >= 2:
            frames += ncoef * (m + 2) ** 2
            m //= 2
    else:
        raise ValueError(f"unknown entry {entry}")
    return frames * item, ops


def split(nlevels, dtype):
    """(top level of the core, peeled levels coarse to fine) of a
    hierarchy of nlevels levels (2^2 .. 2^nlevels cells a side)."""
    top = nlevels - 1
    while 2 ** (top + 1) > CORE_MAX[dtype]:
        top -= 1
    return top, list(range(top + 1, nlevels))


def cycle_launches(n, dtype, op="const"):
    """The launches of one V-cycle of the finest level n^2 from a given
    guess: [(entry, level cells a side, with_guess, want_r)], as
    mg_kernel._cycle makes them: a down a peeled level (the finest with
    the guess, the coarser from zero), the core from zero (its residual
    only when nothing is peeled), an up a peeled level (the residual on
    the finest)."""
    sfx = "" if op == "const" else "_" + op
    nlevels = int(round(math.log2(n)))
    top, peeled = split(nlevels, dtype)
    fine = nlevels - 1
    out = []
    for lv in reversed(peeled):
        out.append((f"mg_down{sfx}", 2 ** (lv + 1), lv == fine, True))
    out.append((f"mg_core{sfx}", 2 ** (top + 1), not peeled, not peeled))
    for lv in peeled:
        out.append((f"mg_up{sfx}", 2 ** (lv + 1), True, lv == fine))
    return out
