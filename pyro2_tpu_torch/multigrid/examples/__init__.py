"""Standalone multigrid verification scripts, doubling as regression
tests (the port of pyro2_tpu/multigrid/examples/).  Each function takes
`device` and `dtype` keywords with the port's defaults: the card and its
working dtype."""

import numpy as np

from pyro2_tpu_torch.mesh.indexer import ai


def l2_error(a, v, exact):
    """The L2 norm over the interior of v minus the numpy array `exact`,
    computed on the host in float64."""
    g = a.soln_grid
    e = ai(v, g).v().cpu().numpy() - ai(exact, g).v()
    return float(np.sqrt(a.dx * a.dy * np.sum(e ** 2)))
