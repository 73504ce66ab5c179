"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

It serves ``TransformerLM`` through ``serving.generate`` and
``serving.InferenceEngine``, and trains through ``jit.TrainStep`` with
``optimizer.AdamW``, ``Adam`` or ``Momentum`` (LR schedulers, gradient
clips, regularizers), ``nn.functional.cross_entropy`` or
``fused_linear_cross_entropy``, and bf16 or float16 AMP (``amp``, switched
on by ``distributed.fleet``'s strategy): bench.py's GPT-medium, LeNet,
ResNet (``vision.models``) and BERT-base programs. Flash attention and
LayerNorm, forward and backward, run on hand-written CUDA kernels
(``ops/kernels``, sources in ``csrc/``). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; there is no silent
fallback to the CPU. The package imports ``torch`` and never ``jax`` or
``paddle_tpu``.
"""
from . import (amp, core, distributed, jit, nn, optimizer, regularizer,
               serving, utils, vision, weights)
from .core import resolve_device
from .ops import arange
from .serving import InferenceEngine, TransformerLM, generate

__all__ = ["amp", "core", "distributed", "jit", "nn", "optimizer",
           "regularizer", "serving", "utils", "vision", "weights",
           "resolve_device",
           "arange", "TransformerLM", "generate", "InferenceEngine"]
