"""Gamma-law equation of state: p = rho e (gamma - 1)
(a copy of pyro2_tpu/solvers/compressible/eos.py)."""


def pres(gamma, rho, eint):
    """Pressure from density and specific internal energy."""
    return rho * eint * (gamma - 1.0)


def dens(gamma, p, eint):
    """Density from pressure and specific internal energy."""
    return p / (eint * (gamma - 1.0))


def rhoe(gamma, p):
    """Internal energy density (rho e) from pressure."""
    return p / (gamma - 1.0)
