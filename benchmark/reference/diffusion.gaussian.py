"""The plain reference of the configuration diffusion.gaussian.

What the program computes for this configuration, as plain PyTorch on
whole frames: the Gaussian's initial data, the Neumann ghost fill, the
timestep with the driver's ladder, and one Crank-Nicolson step: the
right-hand side f = phi + dt/2 k L phi, the solve of the Helmholtz system
(1 - dt/2 k L) phi_new = f under homogeneous Neumann edges, and the
update of the interior (the ghosts keep the fill).  The solve is Jacobi
iteration, independent of the program's multigrid: with alpha = 1 and
beta = dt k / 2 the iteration contracts every error mode by the ratio
`rho` below each sweep, so a count of sweeps fixed from rho takes the
error below the dtype's rounding.  It imports nothing of the program.

Frames are (1, nx + 2, ny + 2) stacks of phi; x is axis 1.
"""

import math

import numpy as np
import torch

NAME = "diffusion.gaussian"
# the numbers the comparison reads (benchmark/harness/checks.py); the
# timestep is the host's arithmetic on the grid spacing, the same in any
# precision of the state, so it is not compared
NUMBERS = ("start_gap", "step_gap")
NG = 1


class Grid:
    """The interior bounds, spacing and cell centres of the domain."""

    def __init__(self, p):
        self.nx, self.ny = int(p["mesh.nx"]), int(p["mesh.ny"])
        self.qx, self.qy = self.nx + 2 * NG, self.ny + 2 * NG
        self.ilo, self.ihi = NG, NG + self.nx - 1
        self.jlo, self.jhi = NG, NG + self.ny - 1
        self.xmin, self.xmax = float(p["mesh.xmin"]), float(p["mesh.xmax"])
        self.ymin, self.ymax = float(p["mesh.ymin"]), float(p["mesh.ymax"])
        self.dx = (self.xmax - self.xmin) / self.nx
        self.dy = (self.ymax - self.ymin) / self.ny
        xl = (np.arange(self.qx) - NG) * self.dx + self.xmin
        yl = (np.arange(self.qy) - NG) * self.dy + self.ymin
        self.x = 0.5 * (xl + (xl + self.dx))
        self.y = 0.5 * (yl + (yl + self.dy))


def win(a, g, i=0, j=0):
    """The interior window of a (..., qx, qy) tensor shifted by i, j."""
    return a[..., g.ilo + i:g.ihi + 1 + i, g.jlo + j:g.jhi + 1 + j]


def initial(p, dtype, device):
    """The analytic Gaussian at t = 0 on the frame, ghosts included, made
    in float64 on the host and rounded once to dtype."""
    g = Grid(p)
    k, t_0 = p["diffusion.k"], p["gaussian.t_0"]
    phi_1, phi_2 = p["gaussian.phi_0"], p["gaussian.phi_max"]
    x2d, y2d = np.meshgrid(g.x, g.y, indexing="ij")
    xctr = 0.5 * (g.xmin + g.xmax)
    yctr = 0.5 * (g.ymin + g.ymax)
    dist = np.sqrt((x2d - xctr) ** 2 + (y2d - yctr) ** 2)
    t = 0.0
    phi = (phi_2 - phi_1) * (t_0 / (t + t_0)) * \
        np.exp(-0.25 * dist ** 2 / (k * (t + t_0))) + phi_1
    return torch.as_tensor(phi[None], dtype=dtype, device=device)


def fill(a, g):
    """Homogeneous Neumann ghosts, in place: x edges, then y edges."""
    a[..., :NG, :] = a[..., NG:NG + 1, :]
    a[..., g.ihi + 1:, :] = a[..., g.ihi:g.ihi + 1, :]
    a[..., :, :NG] = a[..., :, NG:NG + 1]
    a[..., :, g.jhi + 1:] = a[..., :, g.jhi:g.jhi + 1]
    return a


def sweeps(rho, dtype):
    """Jacobi sweeps that shrink every error mode below a sixteenth of
    dtype's rounding, at the contraction rho a sweep."""
    eps = torch.finfo(dtype).eps / 16.0
    return math.ceil(math.log(eps) / math.log(rho))


def helmholtz(f, g, alpha, beta):
    """The solution of (alpha - beta L) x = f (f on the interior, L the
    5-point Laplacian under homogeneous Neumann edges) by Jacobi sweeps
    from x = f."""
    xc, yc = beta / g.dx ** 2, beta / g.dy ** 2
    diag = alpha + 2.0 * xc + 2.0 * yc
    x = torch.zeros((g.qx, g.qy), dtype=f.dtype, device=f.device)
    win(x, g).copy_(f)
    for _ in range(sweeps((2.0 * xc + 2.0 * yc) / diag, f.dtype)):
        fill(x, g)
        new = (f + xc * (win(x, g, 1, 0) + win(x, g, -1, 0)) +
               yc * (win(x, g, 0, 1) + win(x, g, 0, -1))) / diag
        win(x, g).copy_(new)
    return win(x, g)


def check_config(p):
    """Raise unless p is the configuration this reference computes."""
    for edge in ("xl", "xr", "yl", "yr"):
        if p[f"mesh.{edge}boundary"] != "neumann":
            raise ValueError("the gaussian reference takes Neumann edges")
    if p["driver.fix_dt"] > 0.0:
        raise ValueError("the gaussian reference takes the CFL timestep")


def advance(U, t, n, dt_old, steps, p, device_dt):
    """`steps` Crank-Nicolson steps of the host loop from the frame U (its
    interior is phi): fill, the timestep cfl min(dx^2, dy^2) / k through
    the driver's ladder, the right-hand side, the solve, the update.
    Returns (U, the last step's dt)."""
    if device_dt:
        raise ValueError("the diffusion solver has no on-device loop")
    check_config(p)
    g = Grid(p)
    k, cfl = p["diffusion.k"], p["driver.cfl"]
    dt = None
    for _ in range(steps):
        U = fill(U.clone(), g)
        dt = cfl * min(g.dx ** 2 / k, g.dy ** 2 / k)
        if n == 0:
            dt = p["driver.init_tstep_factor"] * dt
        else:
            dt = min(p["driver.max_dt_change"] * dt_old, dt)
        dt_old = dt
        if t + dt > p["driver.tmax"]:
            dt = p["driver.tmax"] - t
        phi = U[0]
        lap = ((win(phi, g, -1, 0) - 2.0 * win(phi, g) + win(phi, g, 1, 0)) /
               g.dx ** 2 +
               (win(phi, g, 0, -1) - 2.0 * win(phi, g) + win(phi, g, 0, 1)) /
               g.dy ** 2)
        f = win(phi, g) + 0.5 * dt * k * lap
        win(U[0], g).copy_(helmholtz(f, g, 1.0, 0.5 * dt * k))
        t = t + dt
        n = n + 1
    return U, dt


def interior(U, p):
    """The interior window of a frame."""
    return win(U, Grid(p))
