"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

This slice serves ``TransformerLM`` through ``serving.generate`` and
``serving.InferenceEngine``, with hand-written CUDA kernels for the flash
attention forward and the LayerNorm forwards (``ops/kernels``, sources in
``csrc/``). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; there is no silent fallback to the CPU. The package
imports ``torch`` and never ``jax`` or ``paddle_tpu``.
"""
from . import core, jit, nn, serving, weights
from .core import resolve_device
from .serving import InferenceEngine, TransformerLM, generate

__all__ = ["core", "jit", "nn", "serving", "weights", "resolve_device",
           "TransformerLM", "generate", "InferenceEngine"]
