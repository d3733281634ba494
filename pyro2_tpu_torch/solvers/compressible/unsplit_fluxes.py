"""The CTU (corner transport upwind) pipeline for compressible flow.

The port of pyro2_tpu/solvers/compressible/unsplit_fluxes.py (Colella 1990
unsplit Godunov, Cartesian and spherical geometry): interface states via
characteristic tracing, interface-state source increments, transverse
Riemann flux corrections, and Colella-Woodward artificial viscosity.  The
interface states and fluxes handed between the stages are fresh tensors of
this pipeline, so the corrections update them in place on their windows.
"""

import torch

import pyro2_tpu_torch.solvers.compressible.interface as ifc
from pyro2_tpu_torch.mesh import reconstruction
from pyro2_tpu_torch.mesh.indexer import ai, aic
from pyro2_tpu_torch.solvers.compressible import riemann


def interface_states(U, my_data, rp, ivars, tc, dt):
    """Left/right conserved states on x and y interfaces: cons -> prim,
    flattening, limited slopes, characteristic tracing, prim -> cons."""
    from pyro2_tpu_torch.solvers.compressible import simulation as comp

    myg = my_data.grid
    gamma = rp.get_param("eos.gamma")

    q = comp.cons_to_prim(U, gamma, ivars, myg, check=False)

    if rp.get_param("compressible.use_flattening"):
        xi_x = reconstruction.flatten(myg, q, 1, ivars, rp)
        xi_y = reconstruction.flatten(myg, q, 2, ivars, rp)
        xi = reconstruction.flatten_multid(myg, q, xi_x, xi_y, ivars)
    else:
        xi = 1.0

    tm_limit = tc.timer("limiting")
    tm_limit.begin()
    limiter = rp.get_param("compressible.limiter")
    ldx = torch.stack([xi * reconstruction.limit(q[n], myg, 1, limiter)
                       for n in range(ivars.nq)])
    ldy = torch.stack([xi * reconstruction.limit(q[n], myg, 2, limiter)
                       for n in range(ivars.nq)])
    tm_limit.end()

    tm_states = tc.timer("interfaceStates")
    tm_states.begin()
    if getattr(myg, "coord_type", 0) == 1:
        # per-cell widths and the d(log A) geometric sources
        V_xl, V_xr = ifc.states(1, myg, myg.tensor("Lx", U),
                                myg.tensor("dlogAx", U), dt, ivars, gamma,
                                q, ldx)
        V_yl, V_yr = ifc.states(2, myg, myg.tensor("Ly", U),
                                myg.tensor("dlogAy", U), dt, ivars, gamma,
                                q, ldy)
    else:
        V_xl, V_xr = ifc.states(1, myg, myg.dx, 0.0, dt, ivars, gamma, q,
                                ldx)
        V_yl, V_yr = ifc.states(2, myg, myg.dy, 0.0, dt, ivars, gamma, q,
                                ldy)
    tm_states.end()

    return tuple(comp.prim_to_cons(V, gamma, ivars, myg)
                 for V in (V_xl, V_xr, V_yl, V_yr))


def apply_source_terms(U_xl, U_xr, U_yl, U_yr, U, t,
                       my_data, my_aux, rp, ivars, tc, dt, *,
                       problem_source=None):
    """Add 0.5*dt of the (ghost-filled) external sources, the problem's
    own included, to the interface states on the buf=1 window, in place.
    Deeper ghosts get nothing: an increment there would leak into the
    interior through the transverse corrections.  The stack's density row
    is filled but added to no state."""
    from pyro2_tpu_torch.solvers.compressible import simulation as comp

    tm_source = tc.timer("sourceTerms")
    tm_source.begin()

    myg = my_data.grid
    src_stack = source_stack(comp.get_external_sources(
        t, dt, U, ivars, rp, myg, problem_source=problem_source), ivars)
    src_stack = my_aux.fill_bc_stack(src_stack, t=t)

    b = 1
    hdt = 0.5 * dt
    sl = (slice(myg.ilo - b, myg.ihi + 2), slice(myg.jlo - b, myg.jhi + 2))

    # left states pick up the source of the zone they came from (i-1 / j-1)
    for n_target, k in ((ivars.ixmom, 1), (ivars.iymom, 2),
                        (ivars.iener, 3)):
        src = ai(src_stack[k], myg)
        U_xl[(n_target,) + sl] += hdt * src.ip(-1, buf=b)
        U_xr[(n_target,) + sl] += hdt * src.v(buf=b)
        U_yl[(n_target,) + sl] += hdt * src.jp(-1, buf=b)
        U_yr[(n_target,) + sl] += hdt * src.v(buf=b)

    tm_source.end()
    return U_xl, U_xr, U_yl, U_yr


def source_stack(S, ivars):
    """The (dens, xmom, ymom, E) source rows the aux container fills."""
    return torch.stack([S[ivars.idens], S[ivars.ixmom], S[ivars.iymom],
                        S[ivars.iener]])


def apply_transverse_flux(U_xl, U_xr, U_yl, U_yr,
                          my_data, rp, ivars, solid, tc, dt):
    """Correct the normal interface states with transverse flux
    differences, in place on the (2, 1) window (the first Riemann pair).
    In spherical geometry the fluxes are weighted by the face areas and
    the cell volume, and the momenta also get the non-conservative
    transverse pressure gradients from the pair's CGF interface states."""
    from pyro2_tpu_torch.solvers.compressible import simulation as comp

    myg = my_data.grid
    spherical = getattr(myg, "coord_type", 0) == 1

    if spherical:
        # CGF (Simulation.initialize refuses the others on this grid)
        F_x, U_x = riemann.riemann_flux(1, U_xl, U_xr, my_data, rp, ivars,
                                        solid.xl, solid.xr, tc,
                                        return_cons=True)
        F_y, U_y = riemann.riemann_flux(2, U_yl, U_yr, my_data, rp, ivars,
                                        solid.yl, solid.yr, tc,
                                        return_cons=True)
        gamma = rp.get_param("eos.gamma")
        qx = comp.cons_to_prim(U_x, gamma, ivars, myg, check=False)
        qy = comp.cons_to_prim(U_y, gamma, ivars, myg, check=False)
    else:
        F_x = riemann.riemann_flux(1, U_xl, U_xr, my_data, rp, ivars,
                                   solid.xl, solid.xr, tc)
        F_y = riemann.riemann_flux(2, U_yl, U_yr, my_data, rp, ivars,
                                   solid.yl, solid.yr, tc)

    tm_transverse = tc.timer("transverse flux addition")
    tm_transverse.begin()

    b = (2, 1)
    hdt = 0.5 * dt
    if spherical:
        V = ai(myg.tensor("V", U_xl), myg)
        Ax = ai(myg.tensor("Ax", U_xl), myg)
        Ay = ai(myg.tensor("Ay", U_xl), myg)
    else:
        # uniform Cartesian geometry: scalar stand-ins
        V = aic(myg.dx * myg.dy)
        Ax = aic(myg.dy)
        Ay = aic(myg.dx)
    Fx = ai(F_x, myg)
    Fy = ai(F_y, myg)
    hdtV = hdt / V.v(buf=b)

    ai(U_xl, myg).v(buf=b).add_(
        -hdtV * (Fy.ip_jp(-1, 1, buf=b) * Ay.ip_jp(-1, 1, buf=b) -
                 Fy.ip(-1, buf=b) * Ay.ip(-1, buf=b)))
    ai(U_xr, myg).v(buf=b).add_(
        -hdtV * (Fy.jp(1, buf=b) * Ay.jp(1, buf=b) -
                 Fy.v(buf=b) * Ay.v(buf=b)))
    ai(U_yl, myg).v(buf=b).add_(
        -hdtV * (Fx.ip_jp(1, -1, buf=b) * Ax.ip_jp(1, -1, buf=b) -
                 Fx.jp(-1, buf=b) * Ax.jp(-1, buf=b)))
    ai(U_yr, myg).v(buf=b).add_(
        -hdtV * (Fx.ip(1, buf=b) * Ax.ip(1, buf=b) -
                 Fx.v(buf=b) * Ax.v(buf=b)))

    if spherical:
        # non-conservative transverse pressure gradients (momenta only),
        # each over the side length of the unshifted cell, as the JAX
        # package writes them
        Lx = ai(myg.tensor("Lx", U_xl), myg).v(buf=b)
        Ly = ai(myg.tensor("Ly", U_xl), myg).v(buf=b)
        px = ai(qx[ivars.ip], myg)
        py = ai(qy[ivars.ip], myg)
        ai(U_xl[ivars.iymom], myg).v(buf=b).add_(
            -hdt * (py.ip_jp(-1, 1, buf=b) - py.ip(-1, buf=b)) / Ly)
        ai(U_xr[ivars.iymom], myg).v(buf=b).add_(
            -hdt * (py.jp(1, buf=b) - py.v(buf=b)) / Ly)
        ai(U_yl[ivars.ixmom], myg).v(buf=b).add_(
            -hdt * (px.ip_jp(1, -1, buf=b) - px.jp(-1, buf=b)) / Lx)
        ai(U_yr[ivars.ixmom], myg).v(buf=b).add_(
            -hdt * (px.ip(1, buf=b) - px.v(buf=b)) / Lx)

    tm_transverse.end()
    return U_xl, U_xr, U_yl, U_yr


def apply_artificial_viscosity(F_x, F_y, q, U, my_data, rp, ivars,
                               edges=(1, 1, 1, 1)):
    """Add Colella-Woodward artificial viscosity to the fluxes, in place
    on the (2, 1) window.  `edges` are the domain-edge flags (xl, xr, yl,
    yr) of interface.artificial_viscosity."""
    cvisc = rp.get_param("compressible.cvisc")
    myg = my_data.grid

    avisco_x, avisco_y = ifc.artificial_viscosity(
        myg, cvisc, q[ivars.iu], q[ivars.iv], edges=edges)

    b = (2, 1)
    avx = ai(avisco_x, myg)
    avy = ai(avisco_y, myg)
    Uv = ai(U, myg)

    ai(F_x, myg).v(buf=b).add_(
        avx.v(buf=b)[None] * (Uv.ip(-1, buf=b) - Uv.v(buf=b)))
    ai(F_y, myg).v(buf=b).add_(
        avy.v(buf=b)[None] * (Uv.jp(-1, buf=b) - Uv.v(buf=b)))
    return F_x, F_y
