"""Ensemble (batch) parallelism: step many same-shape problems together.

The port of pyro2_tpu/parallel/ensemble.py.  The JAX package vmaps a pure
single-state step over a leading batch axis; here the leading batch axis
is written out.  A step that takes the whole batch at once -- one whose
`batched` attribute is true, as the step and fill of
solvers/compressible/padded_step.make_ctu_ensemble_step are (one kernel
launch for every member) -- gets the (n, ...) stack as it is; any other
step is applied member by member and the results stacked.
"""

import torch

__all__ = ["ensemble_step", "ensemble_states"]


def _batched(fn):
    return bool(getattr(fn, "batched", False))


def ensemble_step(step, fill_bc=None):
    """Batch a single-state step over a leading ensemble axis.

    step:    fn (U, *args) -> U for ONE problem state, or a batched step
             (Us, *args) -> Us
    fill_bc: optional ghost-fill fn U -> U (or a batched Us -> Us) applied
             before the step (the per-problem twin of the driver-level
             fill_BC_all)

    Returns fn (Us, *args) -> Us where Us has shape (n_ensemble,
    *U.shape) and *args (t, dt, ...) are shared by every member.
    """
    def fill(Us):
        if fill_bc is None:
            return Us
        if _batched(fill_bc):
            return fill_bc(Us)
        return torch.stack([fill_bc(U) for U in Us])

    def estep(Us, *args):
        Us = fill(Us)
        if _batched(step):
            return step(Us, *args)
        return torch.stack([step(U, *args) for U in Us])

    return estep


def ensemble_states(states):
    """Stack a list of same-shape problem states into an (n, ...) batch."""
    return torch.stack(list(states))
