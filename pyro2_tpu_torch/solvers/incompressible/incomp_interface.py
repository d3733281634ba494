"""Interface-state construction for the incompressible solver.

The port of pyro2_tpu/solvers/incompressible/incomp_interface.py: builds on
the Burgers hat states and transverse corrections, adds the pressure
gradient (and optional extra source) corrections, then Riemann/upwind for
the MAC advective velocities and the full interface states.
"""

from pyro2_tpu_torch.mesh.indexer import ai
from pyro2_tpu_torch.solvers.burgers import burgers_interface
from pyro2_tpu_torch.solvers.burgers.burgers_interface import _add

__all__ = ["mac_vels", "states", "apply_gradp_corrections",
           "apply_other_source_terms"]


def apply_gradp_corrections(g, dt, u_xl, u_xr, u_yl, u_yr,
                            v_xl, v_xr, v_yl, v_yr, gradp_x, gradp_y):
    """Subtract 0.5*dt*gradp from the interface states."""
    gx = ai(gradp_x, g).v(buf=2)
    gy = ai(gradp_y, g).v(buf=2)

    u_xl = _add(u_xl, g, -0.5 * dt * gx, ishift=1)
    u_xr = _add(u_xr, g, -0.5 * dt * gx)
    v_xl = _add(v_xl, g, -0.5 * dt * gy, ishift=1)
    v_xr = _add(v_xr, g, -0.5 * dt * gy)
    v_yl = _add(v_yl, g, -0.5 * dt * gy, jshift=1)
    v_yr = _add(v_yr, g, -0.5 * dt * gy)
    u_yl = _add(u_yl, g, -0.5 * dt * gx, jshift=1)
    u_yr = _add(u_yr, g, -0.5 * dt * gx)
    return u_xl, u_xr, u_yl, u_yr, v_xl, v_xr, v_yl, v_yr


def apply_other_source_terms(g, dt, u_xl, u_xr, u_yl, u_yr,
                             v_xl, v_xr, v_yl, v_yr, source_x, source_y):
    """Add 0.5*dt of any extra velocity sources to the interface states."""
    if source_x is not None:
        sx = ai(source_x, g).v(buf=2)
        u_xl = _add(u_xl, g, 0.5 * dt * sx, ishift=1)
        u_xr = _add(u_xr, g, 0.5 * dt * sx)
        u_yl = _add(u_yl, g, 0.5 * dt * sx, jshift=1)
        u_yr = _add(u_yr, g, 0.5 * dt * sx)
    if source_y is not None:
        sy = ai(source_y, g).v(buf=2)
        v_xl = _add(v_xl, g, 0.5 * dt * sy, ishift=1)
        v_xr = _add(v_xr, g, 0.5 * dt * sy)
        v_yl = _add(v_yl, g, 0.5 * dt * sy, jshift=1)
        v_yr = _add(v_yr, g, 0.5 * dt * sy)
    return u_xl, u_xr, u_yl, u_yr, v_xl, v_xr, v_yl, v_yr


def _corrected_states(g, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy,
                      ldelta_vy, gradp_x, gradp_y, source_x, source_y):
    states8 = burgers_interface.get_interface_states(
        g, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy)
    states8 = burgers_interface.apply_transverse_corrections(g, dt, *states8)
    states8 = apply_gradp_corrections(g, dt, *states8, gradp_x, gradp_y)
    states8 = apply_other_source_terms(g, dt, *states8, source_x, source_y)
    return states8


def mac_vels(g, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy,
             gradp_x, gradp_y, source_x=None, source_y=None):
    """The MAC (staggered normal) advective velocities on x/y edges."""
    u_xl, u_xr, u_yl, u_yr, v_xl, v_xr, v_yl, v_yr = _corrected_states(
        g, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy,
        gradp_x, gradp_y, source_x, source_y)

    u_MAC = burgers_interface.riemann_and_upwind(g, u_xl, u_xr)
    v_MAC = burgers_interface.riemann_and_upwind(g, v_yl, v_yr)
    return u_MAC, v_MAC


def states(g, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy,
           gradp_x, gradp_y, u_MAC, v_MAC, source_x=None, source_y=None):
    """Full interface states of u and v, upwinded by the MAC velocities."""
    u_xl, u_xr, u_yl, u_yr, v_xl, v_xr, v_yl, v_yr = _corrected_states(
        g, dt, u, v, ldelta_ux, ldelta_vx, ldelta_uy, ldelta_vy,
        gradp_x, gradp_y, source_x, source_y)

    u_xint = burgers_interface.upwind(g, u_xl, u_xr, u_MAC)
    v_xint = burgers_interface.upwind(g, v_xl, v_xr, u_MAC)
    u_yint = burgers_interface.upwind(g, u_yl, u_yr, v_MAC)
    v_yint = burgers_interface.upwind(g, v_yl, v_yr, v_MAC)
    return u_xint, v_xint, u_yint, v_yint
