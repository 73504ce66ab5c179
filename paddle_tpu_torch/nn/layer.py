"""``nn.Layer`` and ``ParamAttr`` (counterparts of
``paddle_tpu/nn/layer.py``).

``Layer`` is a ``torch.nn.Module`` with Paddle's surface: parameters are
``core.tensor.Parameter`` (a ``torch.nn.Parameter``), sublayers are
modules, and the parameter and buffer names are the structured names both
packages use (``blocks.0.fc1.weight``), so ``state_dict`` and
``set_state_dict`` read and write the JAX package's layout: a
``paddle_tpu`` model's ``state_dict()`` as numpy arrays loads with no
transposes. Every layer of the port derives from it.

The port's own layers compute on ``torch.Tensor``: a ``forward`` defined
in the package turns ``Tensor`` arguments into their tensors and wraps the
results when an argument was a ``Tensor`` (the boundary of
``core.tensor``), so the conversion happens at the leaves. A ``forward``
defined outside the package (a user's ``Layer``) gets its inputs as they
were passed; a user subclass that keeps a built-in layer's ``forward``
keeps its conversion; ``Sequential`` runs torch's ``forward``, which
converts nothing, so each sublayer sees what the one before returned.
Forward hooks see the arguments as the caller passed them and the
results as the caller gets them.
"""
from __future__ import annotations

import collections
import itertools
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import convert_dtype, default_float_dtype, dtype_name
from ..core.tensor import Parameter, Tensor, tensor_boundary, to_torch
from .initializer import Constant, XavierUniform, _resolve_initializer

__all__ = ["ParamAttr", "Layer"]

_PACKAGE = __name__.split(".")[0]


class ParamAttr:
    """A parameter's attributes: ``name``, ``initializer``,
    ``learning_rate`` (the optimizers multiply their rate by it for this
    parameter), ``regularizer`` (read by the optimizers), ``trainable``
    and ``need_clip`` (read by the gradient clips)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        """``None`` -> defaults; a name -> ``ParamAttr(name=)``; an
        initializer -> ``ParamAttr(initializer=)``; ``False`` stays
        ``False`` (no parameter)."""
        if attr is None:
            return ParamAttr()
        if isinstance(attr, (ParamAttr, bool)):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if callable(attr):
            return ParamAttr(initializer=attr)
        raise TypeError(f"Cannot interpret {attr!r} as ParamAttr")


_name_counters: Dict[str, itertools.count] = collections.defaultdict(
    itertools.count)


class Layer(torch.nn.Module):
    """The base of every layer (``paddle.nn.Layer``)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fwd = cls.__dict__.get("forward")
        module = getattr(fwd, "__module__", None) or ""
        if fwd is not None and module.split(".")[0] == _PACKAGE:
            cls.forward = tensor_boundary(fwd)

    def __init__(self, name_scope: Optional[str] = None, dtype=None):
        super().__init__()
        prefix = name_scope or type(self).__name__.lower()
        self._full_name = f"{prefix}_{next(_name_counters[prefix])}"
        self._dtype = convert_dtype(dtype) or default_float_dtype()

    def __setattr__(self, name, value):
        if isinstance(value, Tensor) and name in self.__dict__.get(
                "_buffers", ()):
            value = value._data
        super().__setattr__(name, value)

    # -- construction ---------------------------------------------------
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, device=None,
                         generator=None) -> Optional[Parameter]:
        """A new ``Parameter`` of ``shape``, drawn by ``attr``'s
        initializer, else ``default_initializer``, else zeros for a bias
        and XavierUniform for a weight (the JAX package's defaults), on
        ``device`` from ``generator`` (the package's defaults when None).
        ``attr=False`` means no parameter (None)."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer or (
            Constant(0.0) if is_bias else XavierUniform())
        data = _resolve_initializer(init)(
            shape, convert_dtype(dtype) or self._dtype,
            device=resolve_device(device), generator=generator)
        p = Parameter(data, requires_grad=bool(attr.trainable) and (
            data.is_floating_point() or data.is_complex()), name=attr.name)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def add_parameter(self, name: str, parameter):
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        """Non-parameter state (``persistable=False`` keeps it out of the
        state dict)."""
        keep = persistable if persistent is None else persistent
        super().register_buffer(name, to_torch(tensor), persistent=keep)
        return tensor

    # -- traversal (lists, as Paddle returns them) -----------------------
    def parameters(self, include_sublayers=True, *, recurse=None
                   ) -> List[torch.nn.Parameter]:
        rec = include_sublayers if recurse is None else recurse
        return list(super().parameters(rec))

    def named_parameters(self, prefix="", include_sublayers=True,
                         remove_duplicate=True, *, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return super().named_parameters(prefix, rec, remove_duplicate)

    def buffers(self, include_sublayers=True, *, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return list(super().buffers(rec))

    def named_buffers(self, prefix="", include_sublayers=True,
                      remove_duplicate=True, *, recurse=None):
        rec = include_sublayers if recurse is None else recurse
        return super().named_buffers(prefix, rec, remove_duplicate)

    def sublayers(self, include_self=False) -> list:
        mods = list(self.modules())
        return mods if include_self else mods[1:]

    def named_sublayers(self, prefix="", include_self=False):
        for name, m in self.named_modules(prefix=prefix):
            if m is not self or include_self:
                yield name, m

    def full_name(self) -> str:
        return self._full_name

    # -- state ----------------------------------------------------------
    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy values (numpy arrays, ``Tensor`` or torch tensors) into
        the parameters and persistent buffers of the same names, each
        cast to its target's type; returns ``(missing, unexpected)``
        names. A shape that differs raises, except the full shape of a
        tensor-parallel shard (``_tp_shard``, ``distributed.meta_parallel``),
        of which this rank's part is kept."""
        own = self.state_dict(keep_vars=True)
        missing = [n for n in own if n not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        for name, target in own.items():
            if name not in state_dict:
                continue
            v = to_torch(state_dict[name])
            v = v.detach() if isinstance(v, torch.Tensor) \
                else torch.tensor(np.asarray(v))
            shard = getattr(target, "_tp_shard", None)
            if shard is not None and tuple(v.shape) == shard.full_shape:
                v = shard.take(v)
            if tuple(v.shape) != tuple(target.shape):
                raise ValueError(
                    f"set_state_dict: {name} has shape {tuple(v.shape)}, "
                    f"the layer's is {tuple(target.shape)}")
            target.copy_(v.to(device=target.device, dtype=target.dtype))
        return missing, unexpected

    set_dict = set_state_dict
    load_dict = set_state_dict

    # -- hooks, mode, misc ----------------------------------------------
    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs) -> None or new outputs``."""
        return self.register_forward_hook(hook)

    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None

    def to(self, device=None, dtype=None, blocking=None, **kwargs):
        """Move to ``device`` ("gpu", "cpu", a Place, a torch device)
        and/or cast the float parameters and buffers to ``dtype`` (a name
        or a torch dtype)."""
        if isinstance(device, torch.dtype) or (
                isinstance(device, str) and _is_dtype_name(device)):
            device, dtype = None, device
        if isinstance(device, torch.Tensor):
            return super().to(device, **kwargs)
        if device is not None:
            kwargs["device"] = resolve_device(device)
        if dtype is not None:
            kwargs["dtype"] = convert_dtype(dtype)
        return super().to(**kwargs)

    def astype(self, dtype):
        return self.to(dtype=dtype)


def _is_dtype_name(s: str) -> bool:
    try:
        dtype_name(s)
    except (ValueError, KeyError):
        return False
    return True
