"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

It serves ``TransformerLM`` through ``serving.generate`` and
``serving.InferenceEngine``, and trains through ``jit.TrainStep`` with
``optimizer.AdamW`` (LR schedulers, gradient clips, regularizers),
``nn.functional.cross_entropy`` or ``fused_linear_cross_entropy``, and
bf16 AMP (``amp``, switched on by ``distributed.fleet``'s strategy), on
hand-written CUDA kernels for flash attention and LayerNorm, forward and
backward (``ops/kernels``, sources in ``csrc/``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; there is no silent
fallback to the CPU. The package imports ``torch`` and never ``jax`` or
``paddle_tpu``.
"""
from . import (amp, core, distributed, jit, nn, optimizer, regularizer,
               serving, utils, weights)
from .core import resolve_device
from .ops import arange
from .serving import InferenceEngine, TransformerLM, generate

__all__ = ["amp", "core", "distributed", "jit", "nn", "optimizer",
           "regularizer", "serving", "utils", "weights", "resolve_device",
           "arange", "TransformerLM", "generate", "InferenceEngine"]
