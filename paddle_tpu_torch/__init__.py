"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

It serves ``TransformerLM`` through ``serving.generate`` and
``serving.InferenceEngine``, and trains it through ``jit.TrainStep`` with
``optimizer.AdamW`` and ``nn.functional.cross_entropy``, on hand-written
CUDA kernels for flash attention and LayerNorm, forward and backward
(``ops/kernels``, sources in ``csrc/``). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``; there is no silent fallback to
the CPU. The package imports ``torch`` and never ``jax`` or
``paddle_tpu``.
"""
from . import core, jit, nn, optimizer, serving, utils, weights
from .core import resolve_device
from .serving import InferenceEngine, TransformerLM, generate

__all__ = ["core", "jit", "nn", "optimizer", "serving", "utils", "weights",
           "resolve_device", "TransformerLM", "generate", "InferenceEngine"]
