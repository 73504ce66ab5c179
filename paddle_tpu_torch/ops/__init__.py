"""Operators of the port: the hand-written CUDA kernels (``kernels``)."""
