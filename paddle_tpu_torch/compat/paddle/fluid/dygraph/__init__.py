"""paddle.fluid.dygraph — the 1.x imperative-mode surface (counterpart of
the JAX package's ``paddle/fluid/dygraph/__init__.py``).

Reference: python/paddle/fluid/dygraph/ (base.py `guard`/`to_variable`,
layers.py `Layer`, checkpoint.py `save_dygraph`/`load_dygraph`). Fluid
semantics: the process default is static graph, and imperative execution
lives inside `with fluid.dygraph.guard(place):`. Here dygraph is the
native mode, so `guard` *forces static off* for its scope and restores
the previous mode on exit — a 1.x dygraph script and a 1.x static script
can share one process, each seeing its expected default.
"""
from __future__ import annotations

import contextlib

import numpy as np

import paddle_tpu_torch as _P
import paddle_tpu_torch.static as _static
from paddle_tpu_torch.core import Tensor, no_grad  # noqa: F401
from paddle_tpu_torch.nn import Layer, LayerList, Sequential, ParameterList  # noqa: F401
from paddle_tpu_torch.distributed.parallel import DataParallel  # noqa: F401

from .nn import BatchNorm, Conv2D, Embedding, Linear, Pool2D  # noqa: F401
from . import nn  # noqa: F401

__all__ = [
    "guard", "enabled", "enable_dygraph", "disable_dygraph",
    "to_variable", "Layer", "LayerList", "Sequential", "ParameterList",
    "Linear", "Conv2D", "Pool2D", "BatchNorm", "Embedding",
    "no_grad", "save_dygraph", "load_dygraph", "DataParallel",
    "prepare_context", "TracedLayer",
]


@contextlib.contextmanager
def guard(place=None):
    """dygraph/base.py:169. Scope-local imperative mode; `place` is
    accepted for parity (the port's device is ``set_device``'s)."""
    was_static = _static._static_mode_on()
    _static._disable()
    try:
        yield
    finally:
        if was_static:
            _static._enable()


def enabled() -> bool:
    return not _static._static_mode_on()


def enable_dygraph(place=None):
    _static._disable()


def disable_dygraph():
    _static._enable()


def to_variable(value, name=None, zero_copy=None, dtype=None):
    """dygraph/base.py:519: ndarray -> Tensor on the current device."""
    if isinstance(value, Tensor):
        return value.astype(dtype) if dtype else value
    arr = np.asarray(value)
    t = _P.to_tensor(arr, dtype=dtype)
    # fluid to_variable returns a LEAF that participates in autograd
    t.stop_gradient = True
    return t


def save_dygraph(state_dict, model_path):
    """checkpoint.py save_dygraph: appends .pdparams/.pdopt by content —
    a parameter dict is all tensors; optimizer state carries non-tensor
    entries (@step counter, LR_Scheduler dict)."""
    all_tensors = all(hasattr(v, "numpy") for v in state_dict.values())
    suffix = ".pdparams" if all_tensors else ".pdopt"
    _P.save(state_dict, model_path + suffix)


def load_dygraph(model_path):
    """checkpoint.py load_dygraph -> (param_dict, opt_dict)."""
    import os

    params, opt = None, None
    if os.path.exists(model_path + ".pdparams"):
        params = _P.load(model_path + ".pdparams")
    if os.path.exists(model_path + ".pdopt"):
        opt = _P.load(model_path + ".pdopt")
    if params is None and opt is None:
        params = _P.load(model_path)
    return params, opt


def prepare_context(strategy=None):
    """dygraph/parallel.py prepare_context: multi-device init."""
    from paddle_tpu_torch.distributed import init_parallel_env

    init_parallel_env()
    return strategy


class TracedLayer:
    """dygraph_to_static TracedLayer: refused, with the JAX package's
    message, so scripts fail with direction, not AttributeError."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "fluid.dygraph.TracedLayer is out of scope: use "
            "paddle.jit.to_static / paddle.jit.save (the TPU path traces "
            "whole programs through XLA, not a per-op static graph)"
        )

    @staticmethod
    def trace(layer, inputs):
        raise NotImplementedError(
            "fluid.dygraph.TracedLayer.trace: use paddle.jit.to_static"
        )
