"""The least work of one CTU step (k_ctu), frozen.

A copy of pyro2_tpu_torch/solvers/compressible/ctu_kernel.py's operation
counts and `work`, as they stood when the benchmark was written: the
program may change, the yardstick may not.  `benchmark/tests/` holds the
copy equal to the program's function at the benchmark's sizes.
"""

# floating-point operations per zone of one step, counted from ctu_step.cu
# for the main path's configuration (HLLC, limiter 2, flattening on, nvar 4,
# no sources, no sponge; +, -, *, /, sqrt, pow each one operation)
FLOPS_PER_ZONE_BY_STAGE = {
    "prim": 11,
    "flatten": 22,
    "states": 420,
    "riemann1": 232,
    "riemann2": 400,
    "update": 36,
}
FLOPS_PER_ZONE = sum(FLOPS_PER_ZONE_BY_STAGE.values())
_TRACED = sum(FLOPS_PER_ZONE_BY_STAGE[k] for k in ("prim", "flatten",
                                                   "states"))
_PAIR = FLOPS_PER_ZONE_BY_STAGE["riemann1"]
_TRANSVERSE = 5 * 2 * 2 * 4
# the stage prefixes of the periodic padded step (stages 1..3); 4 is the
# whole step
FLOPS_PER_ZONE_PREFIX = {1: _TRACED + 3 * 4,
                         2: _TRACED + _PAIR + _TRANSVERSE + 3 * 4,
                         3: _TRACED + 2 * _PAIR + _TRANSVERSE + 4,
                         4: FLOPS_PER_ZONE}
# spherical geometry (CGF, limiter 2, flattening, nvar 4, the sources)
FLOPS_PER_ZONE_SPHERICAL_BY_STAGE = {
    "prim": 11,
    "flatten": 22,
    "states": 466,
    "riemann1": 306,
    "riemann2": 534,
    "update": 83,
}
FLOPS_PER_ZONE_SPHERICAL = sum(FLOPS_PER_ZONE_SPHERICAL_BY_STAGE.values())
# a problem's energy source in the predictor-corrector
FLOPS_PER_ZONE_PROBLEM = 6
# the spherical geometry buffer: planes, lines over i, lines over j
GEOMETRY_PLANES, GEOMETRY_ROWS, GEOMETRY_LANES = 4, 5, 3

ITEMSIZE = {"float32": 4, "float64": 8}


def work(nx, ny, nvar, dtype, with_sources=False, spherical=False,
         n_members=1, problem=False, stages=4):
    """(bytes, operations) one step of n_members states must move and do at
    least: each (nvar, nx + 8, ny + 8) state read once and written once
    (plus the S stack with sources, a problem's weight plane, the
    spherical geometry buffer), and the operations a zone times the
    interior zones.  `dtype` is "float32" or "float64"."""
    item = ITEMSIZE[dtype]
    qx, qy = nx + 8, ny + 8
    values = (2 * nvar + (4 if with_sources else 0) +
              (1 if problem else 0)) * qx * qy
    flops = FLOPS_PER_ZONE_SPHERICAL if spherical else \
        FLOPS_PER_ZONE_PREFIX[stages]
    if problem:
        flops += FLOPS_PER_ZONE_PROBLEM
    if spherical:
        values += GEOMETRY_PLANES * qx * qy + GEOMETRY_ROWS * qx + \
            GEOMETRY_LANES * qy
    return n_members * values * item, n_members * flops * nx * ny
