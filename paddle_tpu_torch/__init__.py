"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The top-level namespace is the Paddle 2.0 dygraph surface of
``paddle_tpu/__init__.py`` for what the port has: ``Tensor``,
``Parameter``, ``to_tensor``, autograd (``loss.backward()``, ``grad``,
``no_grad``), the flat op namespace (``paddle_tpu_torch.matmul``...),
``seed``, ``set_device``/``get_device``, ``get_flags``/``set_flags``,
``ParamAttr`` and ``nn.Layer``, static graphs (``enable_static``,
``static.Program``/``Executor``/``static.nn``), the LoD sequence ops,
``dataset`` and ``text``; a name the port lacks is absent. Import it
as ``paddle`` and a dygraph script runs on the card
(``set_device("cpu")`` for the CPU).

Beneath it, the port serves ``TransformerLM`` through ``serving.generate``
and ``serving.InferenceEngine``, and trains through ``jit.TrainStep`` or
the eager loop with ``optimizer.AdamW``, ``Adam`` or ``Momentum`` (LR
schedulers, gradient clips, regularizers), ``nn.functional.cross_entropy``
or ``fused_linear_cross_entropy``, and bf16 or float16 AMP (``amp``,
switched on by ``distributed.fleet``'s strategy): bench.py's GPT-medium,
LeNet, ResNet (``vision.models``) and BERT-base programs. ``Model``
(``hapi``) trains, evaluates and predicts from ``io.DataLoader``, which
collates in worker processes through the native staging library
(``native``, host C++) and copies each batch to the card once, from pinned
memory; ``save``/``load`` read and write the JAX package's checkpoint
format; ``metric``, ``reader``, ``batch`` and ``vision.datasets`` /
``vision.transforms`` are there too. Flash attention
and LayerNorm, forward and backward, run on hand-written CUDA kernels
(``ops/kernels``, sources in ``csrc/``). Entry points run on ``cuda``
unless the caller passes ``device="cpu"`` or calls ``set_device("cpu")``;
there is no silent fallback to the CPU. The package imports ``torch`` and
never ``jax`` or ``paddle_tpu``. ``compat/paddle`` is its own ``import
paddle`` route (with the fluid tree), which ``python -m
paddle_tpu_torch.run script.py`` puts first on the path; importing this
package does not install it.
"""
from . import (amp, core, distributed, framework, hapi, io, jit, metric,
               native, nn, ops, optimizer, reader, regularizer, serving,
               static, tensor, text, utils, vision)
from . import dataset
from .batch import batch
from .core import (CPUPlace, CUDAPlace, Parameter, Place, Tensor,
                   enable_grad, get_default_dtype, get_device, grad,
                   is_compiled_with_cuda, is_grad_enabled, no_grad,
                   resolve_device, seed, set_default_dtype, set_device,
                   set_grad_enabled, to_tensor)
from .core.flags import get_flags, set_flags
from .distributed.parallel import DataParallel
from .framework.io import load, save
from .hapi import Model, flops, summary
from .nn.layer import ParamAttr
from .ops import *  # noqa: F401,F403
from .ops import creation, linalg, logic, manipulation, math, search, sequence
from .serving import InferenceEngine, TransformerLM, generate


def disable_static(place=None):
    """Back to dygraph (eager) mode, the default."""
    static._disable()


def enable_static():
    """Switch to static-graph mode (``static``): ops that meet a
    ``static.data`` placeholder record into the default program."""
    static._enable()


def in_dynamic_mode() -> bool:
    return not static._static_mode_on()


__all__ = (["amp", "core", "distributed", "framework", "hapi", "io", "jit",
            "metric", "native", "nn", "ops", "optimizer", "reader",
            "regularizer", "serving", "static", "tensor", "text", "utils",
            "vision", "dataset", "batch", "DataParallel", "enable_static",
            "disable_static", "sequence",
            "load", "save", "Model", "flops", "summary",
            "CPUPlace", "CUDAPlace", "Parameter", "Place", "Tensor",
            "enable_grad", "get_default_dtype", "get_device", "grad",
            "is_compiled_with_cuda", "is_grad_enabled", "no_grad",
            "resolve_device", "seed", "set_default_dtype", "set_device",
            "set_grad_enabled", "to_tensor", "get_flags", "set_flags",
            "ParamAttr", "in_dynamic_mode", "creation", "linalg", "logic",
            "manipulation", "math", "search", "TransformerLM", "generate",
            "InferenceEngine"] + ops.__all__)
