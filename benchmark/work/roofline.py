"""Peaks of one NVIDIA H100 SXM and the roofline arithmetic.

Published peaks (NVIDIA's data sheet, SXM part, dense, at the full 700 W
power limit): 3.35 TB/s of HBM3, 66.9 TFLOP/s in float32 and 34 TFLOP/s
in float64 outside the tensor cores.  A share of a roofline is the least
time the work could take on the card, the larger of bytes over bandwidth
and operations over the dtype's peak, over the time it took.
"""

BANDWIDTH = 3.35e12
PEAK_FLOPS = {"float32": 66.9e12, "float64": 34.0e12}


def bound_s(nbytes, flops, dtype):
    """The least seconds one call that moves `nbytes` and does `flops` can
    take on the card."""
    return max(nbytes / BANDWIDTH, flops / PEAK_FLOPS[dtype])


def share_pct(bound, seconds):
    """The share of the roofline in percent, or None with no time."""
    if seconds <= 0.0:
        return None
    return 100.0 * bound / seconds
