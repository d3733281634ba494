"""4th-order (McCorquodale & Colella 2011) limited face-state
reconstruction on tensors.

The port of pyro2_tpu/mesh/fourth_order.py: the per-cell extrema/limiting
decision tree (MC Eqs. 24-32) is nested `torch.where` selects over whole
(qx, qy) arrays; left states at i+1/2 are written through a +1 shift.  The
region masks reproduce the reference's loop ranges exactly (cells outside
them are zero), so downstream windowed reads agree.
"""

import torch

__all__ = ["states", "states_nolimit"]

C2 = 1.25
C3 = 0.1


def _region_mask(g, axis, lo_off, hi_off, t_lo_off, t_hi_off, device):
    """Boolean (qx, qy) mask of the index box [lo+lo_off, hi+hi_off] along
    `axis` and [lo+t_lo_off, hi+t_hi_off] transverse (offsets from the
    inclusive interior bounds)."""
    ii = torch.arange(g.qx, device=device)[:, None]
    jj = torch.arange(g.qy, device=device)[None, :]
    if axis == 0:
        return ((ii >= g.ilo + lo_off) & (ii <= g.ihi + hi_off) &
                (jj >= g.jlo + t_lo_off) & (jj <= g.jhi + t_hi_off))
    return ((jj >= g.jlo + lo_off) & (jj <= g.jhi + hi_off) &
            (ii >= g.ilo + t_lo_off) & (ii <= g.ihi + t_hi_off))


def _sgn(x):
    """copysign(1, x) with copysign(1, 0) == +1."""
    return torch.where(x >= 0.0, 1.0, -1.0).to(x.dtype)


def _shifter(axis):
    def sh(arr, k):
        # sh(arr, k)[i] = arr[i + k] along axis (periodic wrap, as jnp.roll)
        return torch.roll(arr, -k, dims=axis)
    return sh


def _interp(a, sh, m_int):
    """The 4th-order edge interpolant a_{i-1/2} on m_int, zero elsewhere."""
    return torch.where(m_int,
                       (7.0 / 12.0) * (sh(a, -1) + a) -
                       (1.0 / 12.0) * (sh(a, -2) + sh(a, 1)), 0.0)


def states(a, g, idir):
    """4th-order limited left/right edge states along idir (1=x, 2=y).

    al[i] is the left state at the i-1/2 interface.  Valid on the
    reference's loop ranges; zero elsewhere."""
    axis = 0 if idir == 1 else 1
    sh = _shifter(axis)
    dev = a.device

    # the reference's d3a range differs between directions
    d3a_hi = 3 if idir == 1 else 2

    m_int = _region_mask(g, axis, -2, 3, -1, 1, dev)
    m_d2ac = _region_mask(g, axis, -3, 3, -1, 1, dev)
    m_d3a = _region_mask(g, axis, -2, d3a_hi, -1, 1, dev)
    m_W = _region_mask(g, axis, -1, 1, -1, 1, dev)

    a_int = _interp(a, sh, m_int)
    al = a_int
    ar = a_int

    dafm = torch.where(m_int, a - a_int, 0.0)
    dafp = torch.where(m_int, sh(a_int, 1) - a, 0.0)
    d2af = torch.where(m_int, 6.0 * (a_int - 2.0 * a + sh(a_int, 1)), 0.0)
    d2ac = torch.where(m_d2ac, sh(a, -1) - 2.0 * a + sh(a, 1), 0.0)
    d3a = torch.where(m_d3a, d2ac - sh(d2ac, -1), 0.0)

    # ---- the per-cell limiter decision tree over the working window ----
    extrema = ((dafm * dafp <= 0.0) |
               ((a - sh(a, -2)) * (sh(a, 2) - a) <= 0.0))

    s = _sgn(d2ac)
    samesign = ((s == _sgn(sh(d2ac, -1))) & (s == _sgn(sh(d2ac, 1))) &
                (s == _sgn(d2af)))
    d2a_lim = torch.where(
        samesign,
        s * torch.minimum(d2af.abs(),
                          C2 * torch.minimum(sh(d2ac, -1).abs(),
                                             torch.minimum(
                                                 d2ac.abs(),
                                                 sh(d2ac, 1).abs()))),
        0.0)

    maxa = torch.maximum(
        torch.maximum(sh(a, -2).abs(), sh(a, -1).abs()),
        torch.maximum(a.abs(),
                      torch.maximum(sh(a, 1).abs(), sh(a, 2).abs())))
    tiny = d2af.abs() <= 1.e-12 * maxa
    rho = torch.where(tiny, 0.0,
                      d2a_lim / torch.where(d2af == 0.0, 1.0, d2af))

    d3a_min = torch.minimum(torch.minimum(sh(d3a, -1), d3a),
                            torch.minimum(sh(d3a, 1), sh(d3a, 2)))
    d3a_max = torch.maximum(torch.maximum(sh(d3a, -1), d3a),
                            torch.maximum(sh(d3a, 1), sh(d3a, 2)))

    dolim = ((rho < 1.0 - 1.e-12) &
             (C3 * torch.maximum(d3a_min.abs(), d3a_max.abs()) <=
              d3a_max - d3a_min))

    case1 = dafm * dafp < 0.0
    case2 = ~case1 & (dafm.abs() >= 2.0 * dafp.abs())
    case3 = ~case1 & ~case2 & (dafp.abs() >= 2.0 * dafm.abs())

    al_up = sh(al, 1)    # current al[i+1], the default for this cell's left

    # extrema + limiting active
    ar_lim = torch.where(case1, a - rho * dafm,
                         torch.where(case2,
                                     a - 2.0 * (1.0 - rho) * dafp - rho * dafm,
                                     ar))
    al_lim = torch.where(case1, a + rho * dafp,
                         torch.where(case3,
                                     a + 2.0 * (1.0 - rho) * dafm + rho * dafp,
                                     al_up))

    # no extrema: independent one-sided limits
    ar_ne = torch.where(dafm.abs() >= 2.0 * dafp.abs(), a - 2.0 * dafp, ar)
    al_ne = torch.where(dafp.abs() >= 2.0 * dafm.abs(), a + 2.0 * dafm,
                        al_up)

    ar_cell = torch.where(extrema, torch.where(dolim, ar_lim, ar), ar_ne)
    al_cell = torch.where(extrema, torch.where(dolim, al_lim, al_up), al_ne)

    ar = torch.where(m_W, ar_cell, ar)
    # al[i+1] <- al_cell[i]: shift the cell values up by one, on the
    # +1-shifted box
    m_W_up = _region_mask(g, axis, 0, 2, -1, 1, dev)
    al = torch.where(m_W_up, torch.roll(al_cell, 1, dims=axis), al)

    return al, ar


def states_nolimit(a, g, idir):
    """Unlimited 4th-order edge states (al == ar == the interpolant)."""
    axis = 0 if idir == 1 else 1
    a_int = _interp(a, _shifter(axis),
                    _region_mask(g, axis, -2, 3, -1, 1, a.device))
    return a_int, a_int
