"""Automatic mixed precision (counterpart of ``paddle_tpu/amp/__init__.py``).

Paddle casts by operator name: a white-listed op takes its float inputs in
the low-precision type, a black-listed op in float32, and every other op
as they come. ``paddle_tpu`` does it in one hook of its op dispatcher; the
port has no dispatcher, so each port function that ``paddle_tpu`` reaches
under a listed name calls :func:`cast_if_amp` with that name first
(``nn.functional.linear``, ``flash_core``, the dense attention products,
``softmax``, the dense ``layer_norm``, ``cross_entropy``). This is not
``torch.autocast``: its op lists are PyTorch's, differ between the CPU and
CUDA backends, and do not reach the port's autograd Functions.

A cast is ``Tensor.to``, so it is differentiable: a float32 parameter
cast to bfloat16 for a product gets its gradient back in float32.

bfloat16 is the default low-precision type and needs no loss scaling;
:class:`GradScaler` scales only when asked (float16).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterable, Tuple

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "is_enabled",
           "amp_dtype", "should_cast_down", "cast_if_amp", "decorate",
           "GradScaler"]

# op categories (imperative/amp_auto_cast.cc AmpOperators)
WHITE_LIST = {"matmul", "linear", "conv2d", "conv1d", "conv3d", "einsum",
              "bmm", "mm", "mv", "attention_scores", "attention_context",
              "flash_attention"}
# fused_layer_norm / fused_residual_layer_norm are deliberately on NEITHER
# list: the kernels take bf16 activations as they come and do their
# statistics in f32 inside -- black-listing them would bring back the f32
# round trip through memory that they exist to remove (the dense
# "layer_norm" stays black-listed). fused_linear_cross_entropy likewise:
# its vocab-chunk products accumulate in f32 while the [N, d] hidden input
# stays in the compute type.
BLACK_LIST = {"softmax", "log_softmax", "cross_entropy", "mean", "sum",
              "layer_norm", "exp", "log", "logsumexp",
              "softmax_with_cross_entropy"}
# batch_norm is deliberately NOT black-listed: it keeps its statistics in
# f32 inside while applying in the input type

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def _to_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(f"amp: unknown dtype {dtype!r}")
    return _DTYPES[dtype]


class _AmpState(threading.local):
    def __init__(self):
        self.enabled = False
        self.dtype = torch.bfloat16
        self.level = "O1"
        self.custom_white = set()
        self.custom_black = set()


_state = _AmpState()


def is_enabled() -> bool:
    return _state.enabled


def amp_dtype() -> torch.dtype:
    return _state.dtype


def should_cast_down(op_name: str) -> bool:
    if not _state.enabled:
        return False
    if op_name in _state.custom_black or op_name in BLACK_LIST:
        return False
    if _state.level == "O2":
        return True
    return op_name in WHITE_LIST or op_name in _state.custom_white


def _cast_floats(tensors, dtype) -> Tuple:
    return tuple(
        t.to(dtype) if isinstance(t, torch.Tensor) and t.is_floating_point()
        and t.dtype != dtype else t
        for t in tensors)


def cast_if_amp(op_name: str, tensors: Iterable) -> Tuple:
    """The inputs of op ``op_name`` as AMP gives them to it: float tensors
    cast down to the AMP type for a white-listed op (every op but the
    black-listed ones at O2), up to float32 for a black-listed op, and
    passed through otherwise. Non-float entries (labels, None) pass
    through."""
    tensors = tuple(tensors)
    if not _state.enabled or op_name is None:
        return tensors
    if op_name in _state.custom_black or op_name in BLACK_LIST:
        return _cast_floats(tensors, torch.float32)
    if should_cast_down(op_name):
        return _cast_floats(tensors, _state.dtype)
    return tensors


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """paddle.amp.auto_cast: inside the block, the port's functions cast
    their inputs by the lists above (thread-local; restored on exit)."""
    if level not in ("O1", "O2"):
        raise ValueError(f"amp: level must be O1 or O2, got {level!r}")
    prev = (_state.enabled, _state.dtype, _state.level,
            _state.custom_white, _state.custom_black)
    _state.enabled = bool(enable)
    _state.dtype = _to_dtype(dtype)
    _state.level = level
    _state.custom_white = set(custom_white_list or ())
    _state.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (_state.enabled, _state.dtype, _state.level,
         _state.custom_white, _state.custom_black) = prev


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """paddle.amp.decorate: at O2 the models' float parameters and buffers
    are cast to the AMP type in place (the optimizer's moments, created
    on first use, follow the parameters' type). O1 changes nothing."""
    if level == "O2":
        d = _to_dtype(dtype)
        for m in models if isinstance(models, (list, tuple)) else [models]:
            m.to(dtype=d)
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (paddle's ``GradScaler``).

    ``scale(loss)`` multiplies by the scale; ``step(optimizer)`` divides
    the gradients by it, skips the update when any gradient is not finite
    and then backs the scale off every ``decr_every_n_nan_or_inf`` bad
    steps, or grows it after ``incr_every_n_steps`` good ones. bf16 needs
    none of this: with ``enable=False`` every call passes through. The
    eager ``step`` reads the finite flag on the host, once per call, as
    the JAX package's does; ``jit.TrainStep`` keeps its scaler state on
    the device instead."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling and enable
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, loss: torch.Tensor) -> torch.Tensor:
        if not self._enable or self._scale == 1.0:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer) -> None:
        """Divide every gradient by the scale in place and record whether
        any is not finite (one reduction over all gradients, one host
        read)."""
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._get_params()
                 if p.grad is not None]
        if not grads:
            self._found_inf = False
            return
        for g in grads:
            g.div_(self._scale)
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        self._found_inf = not bool(finite)

    def step(self, optimizer) -> None:
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._dynamic and self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            optimizer.step()
            self._good_steps += 1
            self._bad_steps = 0
            if self._dynamic and self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def update(self) -> None:
        """Folded into :meth:`step`, as in the JAX package."""

    def minimize(self, optimizer, scaled_loss) -> None:
        scaled_loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def get_loss_scaling(self) -> float:
        return self._scale

    def state_dict(self) -> dict:
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every,
            "decr_every_n_nan_or_inf": self._decr_every,
            "good_steps": self._good_steps,
            "bad_steps": self._bad_steps,
        }

    def load_state_dict(self, state) -> None:
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)
