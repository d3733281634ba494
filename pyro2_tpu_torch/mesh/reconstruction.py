"""Slope limiters and shock flattening on tensors.

The port of pyro2_tpu/mesh/reconstruction.py.  The limiter functions take full (qx, qy) padded tensors (or (nvar, qx,
qy) stacks) and return full padded tensors whose buf=2 window holds the
result; cells outside that window are zero (flattening: one), so
downstream windowed reads agree exactly with the JAX package.
"""

import torch

from pyro2_tpu_torch.mesh.indexer import ai, embed

__all__ = ["limit", "nolimit", "limit2", "limit4", "well_balance",
           "flatten", "flatten_multid", "weno_upwind", "weno"]


def _mc(dc, dl, dr):
    """The monotonized-central limiter combination."""
    d1 = 2.0 * torch.where(dl.abs() < dr.abs(), dl, dr)
    dt = torch.where(dc.abs() < d1.abs(), dc, d1)
    return torch.where(dl * dr > 0.0, dt, 0.0)


def limit(data, g, idir, limiter):
    """Dispatch on the limiter runtime parameter (0/1/other -> 4th-order)."""
    if limiter == 0:
        return nolimit(data, g, idir)
    if limiter == 1:
        return limit2(data, g, idir)
    return limit4(data, g, idir)


def _diffs(av, idir):
    """(a[+1], a[0], a[-1]) on the buf=2 window along idir."""
    if idir == 1:
        return av.ip(1, buf=2), av.v(buf=2), av.ip(-1, buf=2)
    return av.jp(1, buf=2), av.v(buf=2), av.jp(-1, buf=2)


def nolimit(a, g, idir):
    """Centered difference, no limiting."""
    p, _c, m = _diffs(ai(a, g), idir)
    return embed(0.5 * (p - m), g, 2)


def limit2(a, g, idir):
    """2nd-order monotonized central-difference limiter."""
    p, c, m = _diffs(ai(a, g), idir)
    return embed(_mc(0.5 * (p - m), p - c, c - m), g, 2)


def limit4(a, g, idir):
    """4th-order monotonized central-difference limiter."""
    tp, _tc, tm = _diffs(ai(limit2(a, g, idir), g), idir)
    p, c, m = _diffs(ai(a, g), idir)
    dc = (2.0 / 3.0) * (p - m - 0.25 * (tp + tm))
    return embed(_mc(dc, p - c, c - m), g, 2)


def well_balance(q, g, limiter, iv, grav):
    """The MC-limited y slope of the pressure with hydrostatic equilibrium
    subtracted, on the buf=2 window (zero outside it).  q is the primitive
    stack; only limiter 1 is supported."""
    if limiter != 1:
        raise ValueError("well-balanced only works for limiter == 1")

    p = ai(q[iv.ip], g)
    rho = ai(q[iv.irho], g)

    # the neighbours' deviations from the hydrostatic extrapolation of the
    # cell's pressure (the cell's own deviation is zero)
    p1_jp1 = (p.jp(1, buf=2) -
              (p.v(buf=2) + 0.5 * g.dy *
               (rho.v(buf=2) + rho.jp(1, buf=2)) * grav))
    p1_jm1 = (p.jp(-1, buf=2) -
              (p.v(buf=2) - 0.5 * g.dy *
               (rho.v(buf=2) + rho.jp(-1, buf=2)) * grav))

    return embed(_mc(0.5 * (p1_jp1 - p1_jm1), p1_jp1, -p1_jm1), g, 2)


def flatten(g, q, idir, ivars, rp):
    """1-D Colella flattening coefficient xi in [0, 1].

    q is the primitive stack; rp supplies compressible.{delta,z0,z1}.
    Cells outside the buf=2 window get xi=1."""
    delta = rp.get_param("compressible.delta")
    z0 = rp.get_param("compressible.z0")
    z1 = rp.get_param("compressible.z1")
    smallp = 1.0e-10

    p = ai(q[ivars.ip], g)
    if idir == 1:
        un = ai(q[ivars.iu], g)
        dp1 = (p.ip(1, buf=2) - p.ip(-1, buf=2)).abs()
        dp2 = (p.ip(2, buf=2) - p.ip(-2, buf=2)).abs()
        t2_w = dp1 / torch.minimum(p.ip(1, buf=2), p.ip(-1, buf=2))
        t1_w = un.ip(-1, buf=2) - un.ip(1, buf=2)
    else:
        un = ai(q[ivars.iv], g)
        dp1 = (p.jp(1, buf=2) - p.jp(-1, buf=2)).abs()
        dp2 = (p.jp(2, buf=2) - p.jp(-2, buf=2)).abs()
        t2_w = dp1 / torch.minimum(p.jp(1, buf=2), p.jp(-1, buf=2))
        t1_w = un.jp(-1, buf=2) - un.jp(1, buf=2)
    z_w = dp1 / dp2.clamp_min(smallp)

    z = embed(z_w, g, 2)
    t1 = embed(t1_w, g, 2)
    t2 = embed(t2_w, g, 2)

    xi = (1.0 - (z - z0) / (z1 - z0)).clamp_min(0.0).clamp_max(1.0)
    return torch.where((t1 > 0.0) & (t2 > delta), xi, 1.0)


def flatten_multid(g, q, xi_x, xi_y, ivars):
    """Multidimensional flattening: min over upwinded neighbor coefficients."""
    p = ai(q[ivars.ip], g)
    xx = ai(xi_x, g)
    xy = ai(xi_y, g)

    px = torch.where(p.ip(1, buf=2) - p.ip(-1, buf=2) > 0,
                     xx.ip(-1, buf=2), xx.ip(1, buf=2))
    py = torch.where(p.jp(1, buf=2) - p.jp(-1, buf=2) > 0,
                     xy.jp(-1, buf=2), xy.jp(1, buf=2))

    v = torch.minimum(torch.minimum(xx.v(buf=2), px),
                      torch.minimum(xy.v(buf=2), py))
    return embed(v, g, 2)


# ---------------------------------------------------------------------------
# WENO reconstruction
# ---------------------------------------------------------------------------

C_all = {2: [1 / 3, 2 / 3],
         3: [1 / 10, 6 / 10, 3 / 10]}

a_all = {2: [[3 / 2, -1 / 2], [1 / 2, 1 / 2]],
         3: [[11 / 6, -7 / 6, 2 / 6], [2 / 6, 5 / 6, -1 / 6],
             [-1 / 6, 5 / 6, 2 / 6]]}

sigma_all = {
    2: [[[1, 0], [-2, 1]],
        [[1, 0], [-2, 1]]],
    3: [[[40 / 12, 0, 0], [-124 / 12, 100 / 12, 0],
         [44 / 12, -76 / 12, 16 / 12]],
        [[16 / 12, 0, 0], [-52 / 12, 52 / 12, 0],
         [20 / 12, -52 / 12, 16 / 12]],
        [[16 / 12, 0, 0], [-76 / 12, 100 / 12, 0],
         [44 / 12, -124 / 12, 40 / 12]]],
}


def _weno_combine(get, order):
    """WENO combination given get(o) -> q shifted by o zones (tensors).

    The coefficients are the JAX package's numpy tables as Python floats
    (the same doubles), applied in its order of operations."""
    a_t = a_all[order]
    C = C_all[order]
    sigma = sigma_all[order]
    epsilon = 1e-16

    alphas = []
    stencils = []
    for k in range(order):
        beta = 0.0
        for l in range(order):
            for m in range(l + 1):
                if sigma[k][l][m] != 0.0:
                    beta = beta + sigma[k][l][m] * get(k - l) * get(k - m)
        # a tensor numerator: a Python float over a tensor would be
        # reciprocal-then-multiply in torch, two roundings
        den = epsilon + beta ** 2
        alphas.append(torch.full_like(den, C[k]) / den)
        st = 0.0
        for l in range(order):
            st = st + a_t[k][l] * get(k - l)
        stencils.append(st)

    alpha_sum = sum(alphas)
    out = 0.0
    for k in range(order):
        out = out + (alphas[k] / alpha_sum) * stencils[k]
    return out


def weno_upwind(q, order):
    """Left-biased WENO reconstruction of one (2*order-1)-point stencil."""
    q = torch.as_tensor(q)

    def get(o):
        return q[order - 1 + o]
    return _weno_combine(get, order)


def weno(q, order, axis=-1):
    """WENO reconstruction along `axis` of an N-d tensor.

    Returns (q_minus, q_plus): left/right biased face values at each cell,
    valid for indices [order, n-order) along axis and zero outside.  The
    shifts wrap around the array as the JAX package's jnp.roll does."""
    n = q.shape[axis]

    def shifted(o):
        return torch.roll(q, -o, dims=axis)

    q_plus = _weno_combine(shifted, order)
    q_minus = _weno_combine(lambda o: shifted(-o), order)

    idx = torch.arange(n, device=q.device)
    shape = [1] * q.ndim
    shape[axis] = n
    valid = ((idx >= order) & (idx < n - order)).reshape(shape)
    return torch.where(valid, q_minus, 0.0), torch.where(valid, q_plus, 0.0)
