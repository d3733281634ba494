"""Lagrangian tracer particles (the port of pyro2_tpu/particles/)."""

from pyro2_tpu_torch.particles.particles import Particles

__all__ = ["Particles"]
