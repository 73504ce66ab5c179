"""Operators of the port: the hand-written CUDA kernels (``kernels``) and
tensor creation (``creation``)."""
from .creation import arange

__all__ = ["arange"]
