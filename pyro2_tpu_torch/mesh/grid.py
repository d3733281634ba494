"""2-D ghost-cell grid geometry.

A copy of pyro2_tpu/mesh/grid.py.  Grids are static host-side objects:
hashable and compared structurally.  All coordinate/geometry arrays are host
numpy (float64); solvers convert them to tensors of the working dtype on use.

Index layout (1-d view)::

   |<- ng ghosts ->|<-------- nx interior -------->|<- ng ghosts ->|
   0 ...     ilo-1  ilo                        ihi  ihi+1 ... qx-1
"""

import numpy as np

__all__ = ["Grid2d", "Cartesian2d", "SphericalPolar"]


class Grid2d:
    """The 2-d grid: discretization only; BCs live with each variable."""

    def __init__(self, nx, ny, *, ng=1,
                 xmin=0.0, xmax=1.0, ymin=0.0, ymax=1.0,
                 _coord_shift=(0, 0), _domain_n=None):
        """_coord_shift/_domain_n make a BLOCK grid: shape (nx, ny) but
        coordinates of the window starting at interior cell _coord_shift of
        a (_domain_n) global grid spanning [xmin,xmax]x[ymin,ymax] -- the
        same float expressions as the global grid's, so block coordinates
        are bitwise equal to the global window (see parallel/blocks.py)."""
        self.nx = int(nx)
        self.ny = int(ny)
        self.ng = int(ng)

        self.qx = 2 * self.ng + self.nx
        self.qy = 2 * self.ng + self.ny

        self.xmin = float(xmin)
        self.xmax = float(xmax)
        self.ymin = float(ymin)
        self.ymax = float(ymax)

        # interior index bounds (inclusive)
        self.ilo = self.ng
        self.ihi = self.ng + self.nx - 1
        self.jlo = self.ng
        self.jhi = self.ng + self.ny - 1

        # center indices (for convenience, reference patch.py:119)
        self.ic = self.ilo + self.nx // 2 - 1
        self.jc = self.jlo + self.ny // 2 - 1

        dn_x, dn_y = _domain_n if _domain_n is not None else (self.nx,
                                                              self.ny)
        self._coord_shift = (int(_coord_shift[0]), int(_coord_shift[1]))
        self._domain_n = (int(dn_x), int(dn_y))
        sx, sy = self._coord_shift

        self.dx = (self.xmax - self.xmin) / dn_x
        self.dy = (self.ymax - self.ymin) / dn_y

        # 1-d coordinates at left edge / center / right edge, incl. ghosts
        self.xl = (np.arange(self.qx) + sx - self.ng) * self.dx + self.xmin
        self.xr = self.xl + self.dx
        self.x = 0.5 * (self.xl + self.xr)

        self.yl = (np.arange(self.qy) + sy - self.ng) * self.dy + self.ymin
        self.yr = self.yl + self.dy
        self.y = 0.5 * (self.yl + self.yr)

        # 2-d coordinate fields (host numpy, indexing='ij': x is axis 0)
        self.x2d, self.y2d = np.meshgrid(self.x, self.y, indexing="ij")
        self.xl2d, self.yl2d = np.meshgrid(self.xl, self.yl, indexing="ij")
        self.xr2d, self.yr2d = np.meshgrid(self.xr, self.yr, indexing="ij")

    # -- allocation ---------------------------------------------------------
    def scratch_array(self, *, nvar=1, dtype=None, device=None):
        """A zeroed tensor with this grid's padded shape.

        (qx, qy) for nvar == 1, else (nvar, qx, qy) -- variables major so
        each field is a contiguous plane with y the fastest-varying dim.
        `device` defaults to CUDA and raises when there is none; `dtype`
        defaults to the device's working dtype.
        """
        import torch

        from pyro2_tpu_torch.defaults import dtype as working_dtype
        from pyro2_tpu_torch.defaults import resolve_device

        device = resolve_device(device)
        dtype = working_dtype(device, dtype)
        shape = (self.qx, self.qy) if nvar == 1 else (nvar, self.qx, self.qy)
        return torch.zeros(shape, dtype=dtype, device=device)

    def tensor(self, name, like):
        """The host array `name` (Lx, Ly, Ax, Ay, V, dlogAx, x2d, ...) as
        a new tensor of `like`'s dtype on its device.  The array is copied
        to a device once per dtype and device (a copy from pageable host
        memory stalls the host until the device has caught up); each call
        returns a clone of that copy, so a caller may write into it."""
        import torch

        key = (name, like.dtype, like.device)
        cache = self.__dict__.setdefault("_tensors", {})
        if key not in cache:
            cache[key] = torch.as_tensor(getattr(self, name),
                                         dtype=like.dtype, device=like.device)
        return cache[key].clone()

    # -- refinement relatives ----------------------------------------------
    def coarse_like(self, N):
        """A grid coarsened by an integer factor N, same extents/ghosts."""
        return type(self)(self.nx // N, self.ny // N, ng=self.ng,
                          xmin=self.xmin, xmax=self.xmax,
                          ymin=self.ymin, ymax=self.ymax)

    def fine_like(self, N):
        """A grid refined by an integer factor N, same extents/ghosts."""
        return type(self)(self.nx * N, self.ny * N, ng=self.ng,
                          xmin=self.xmin, xmax=self.xmax,
                          ymin=self.ymin, ymax=self.ymax)

    # -- structural identity (grids are static/hashable for jit closures) ---
    def _key(self):
        return (self.nx, self.ny, self.ng,
                self.xmin, self.xmax, self.ymin, self.ymax,
                self._coord_shift, self._domain_n)

    def __eq__(self, other):
        return isinstance(other, Grid2d) and self._key() == other._key()

    def __hash__(self):
        return hash((type(self).__name__,) + self._key())

    def __str__(self):
        return f"2-d grid: nx = {self.nx}, ny = {self.ny}, ng = {self.ng}"


class Cartesian2d(Grid2d):
    """Cartesian geometry: unit metric factors (reference patch.py:192-233)."""

    coord_type = 0

    def __init__(self, nx, ny, *, ng=1,
                 xmin=0.0, xmax=1.0, ymin=0.0, ymax=1.0,
                 _coord_shift=(0, 0), _domain_n=None):
        super().__init__(nx, ny, ng=ng, xmin=xmin, xmax=xmax,
                         ymin=ymin, ymax=ymax,
                         _coord_shift=_coord_shift, _domain_n=_domain_n)

        shape = (self.qx, self.qy)
        self.Lx = np.full(shape, self.dx)
        self.Ly = np.full(shape, self.dy)
        # face areas: Ax is perpendicular to x, Ay perpendicular to y
        self.Ax = self.Ly
        self.Ay = self.Lx
        self.dlogAx = np.zeros(shape)
        self.dlogAy = np.zeros(shape)
        self.V = np.full(shape, self.dx * self.dy)

    def __str__(self):
        return (f"Cartesian 2D Grid: xmin = {self.xmin}, xmax = {self.xmax}, "
                f"ymin = {self.ymin}, ymax = {self.ymax}, "
                f"nx = {self.nx}, ny = {self.ny}, ng = {self.ng}")


class SphericalPolar(Grid2d):
    """Spherical polar (r = x, theta = y) with azimuthal symmetry.

    Geometry factors follow the reference (patch.py:242-305): exact
    integrated face areas / volumes and the d(log A) geometric source terms.
    """

    coord_type = 1

    def __init__(self, nx, ny, *, ng=1,
                 xmin=0.2, xmax=1.0, ymin=0.0, ymax=1.0,
                 _coord_shift=(0, 0), _domain_n=None):
        super().__init__(nx, ny, ng=ng, xmin=xmin, xmax=xmax,
                         ymin=ymin, ymax=ymax,
                         _coord_shift=_coord_shift, _domain_n=_domain_n)

        assert ymin >= 0.0 and ymax <= np.pi, \
            "y (theta) must lie within [0, pi]"
        assert xmin - ng * self.dx >= 0.0, \
            "xmin (r) must keep all ghost cells at r >= 0"

        shape = (self.qx, self.qy)
        # cell side lengths: dr and r*dtheta
        self.Lx = np.full(shape, self.dx)
        self.Ly = self.x2d * self.dy

        # area of the face perpendicular to r:  |-2 pi r_l^2 (cos th_r - cos th_l)|
        self.Ax = np.abs(-2.0 * np.pi * self.xl2d ** 2 *
                         (np.cos(self.yr2d) - np.cos(self.yl2d)))
        # area of the face perpendicular to theta:  |pi sin th_l (r_r^2 - r_l^2)|
        self.Ay = np.abs(np.pi * np.sin(self.yl2d) *
                         (self.xr2d ** 2 - self.xl2d ** 2))

        # sin(theta) at the lower edge, the centre and the centre below,
        # for the vertex divergence of the artificial viscosity
        self.sin_yl = np.sin(self.yl)
        self.sin_y = np.sin(self.y)
        self.sin_yb = np.sin(self.y - self.dy)

        # d log(A)/dr = 2/r ; d log(A)/(r dtheta) = cot(theta)/r
        self.dlogAx = 2.0 / self.x2d
        self.dlogAy = 1.0 / (np.tan(self.y2d) * self.x2d)

        # exact cell volume
        self.V = np.abs(-2.0 * np.pi / 3.0 *
                        (np.cos(self.yr2d) - np.cos(self.yl2d)) *
                        (self.xr2d - self.xl2d) *
                        (self.xr2d ** 2 + self.xl2d ** 2 +
                         self.xr2d * self.xl2d))

    def __str__(self):
        return ("Spherical Polar 2D Grid: x : r, y : theta. "
                f"xmin (r) = {self.xmin}, xmax = {self.xmax}, "
                f"ymin = {self.ymin}, ymax = {self.ymax}, "
                f"nx = {self.nx}, ny = {self.ny}, ng = {self.ng}")
