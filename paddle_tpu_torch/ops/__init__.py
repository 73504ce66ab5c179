"""Operators of the port: the hand-written CUDA kernels (``kernels``),
tensor creation (``creation``) and shape manipulation
(``manipulation``)."""
from .creation import arange
from .manipulation import flatten

__all__ = ["arange", "flatten"]
