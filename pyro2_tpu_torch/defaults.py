"""Device and dtype policy.

Entry points run on CUDA unless the caller names another device: with no
GPU and no explicit ``device="cpu"`` they raise instead of quietly running
on the CPU.  The working dtype is an explicit argument; its default is
float32 on CUDA (the speed mode, as float32 was on the TPU) and float64 on
the CPU (the parity mode the tests use against the JAX package).
"""

import torch

__all__ = ["resolve_device", "dtype"]


def resolve_device(device=None):
    """The torch.device an entry point runs on (CUDA by default)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def dtype(device, dtype=None):
    """The working dtype: `dtype` if given, else f32 on CUDA, f64 on CPU."""
    if dtype is not None:
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"unsupported working dtype {dtype}")
        return dtype
    return torch.float32 if torch.device(device).type == "cuda" \
        else torch.float64
