"""Eager autograd of the Paddle surface (counterpart of
``paddle_tpu/core/autograd.py``), on PyTorch's autograd engine.

The JAX package records a tape of per-op VJPs and walks it in
``run_backward``; here the engine is torch's: a ``Tensor`` holds a
``torch.Tensor`` whose ``grad_fn`` is the tape, ``backward()`` is
``torch.autograd.backward`` and ``grad`` is ``torch.autograd.grad``.
What this module adds is Paddle's surface over it: ``no_grad``,
``enable_grad``, ``set_grad_enabled`` (a function returning the previous
mode), ``is_grad_enabled``, ``grad`` with Paddle's arguments, and
:func:`apply`, the one seam every eager op of ``ops/`` goes through:

- the AMP cast by op name (``amp.cast_if_amp`` with the op's name, where
  the JAX package's ``_maybe_amp_cast`` casts at its tape's seam);
- ``FLAGS_check_nan_inf``: a forward output that is not finite raises
  :class:`NanInfError` naming the op, and so does a gradient that the op's
  backward computes for its inputs (a hook on the output's ``grad_fn``);
- wrapping the results as ``Tensor``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .. import amp
from .flags import flag

__all__ = ["no_grad", "enable_grad", "set_grad_enabled", "is_grad_enabled",
           "grad", "run_backward", "apply", "NanInfError"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled


def set_grad_enabled(mode: bool) -> bool:
    """Switch gradient recording on or off; returns the previous mode."""
    prev = torch.is_grad_enabled()
    torch.set_grad_enabled(bool(mode))
    return prev


class NanInfError(RuntimeError):
    """``FLAGS_check_nan_inf``'s verdict: op ``op_name`` produced NaN/Inf
    in ``phase`` ("forward", or "backward" for the gradients its backward
    computed)."""

    def __init__(self, op_name: str, phase: str = "forward",
                 detail: str = ""):
        self.op_name = op_name
        self.phase = phase
        super().__init__(
            f"FLAGS_check_nan_inf: {'grad of ' if phase == 'backward' else ''}"
            f"op '{op_name}' produced NaN/Inf{detail}")


def _nonfinite(t) -> bool:
    return isinstance(t, torch.Tensor) and (
        t.is_floating_point() or t.is_complex()) and \
        not bool(torch.isfinite(t).all())


def _check_forward(name: str, outs) -> None:
    for i, o in enumerate(outs):
        if _nonfinite(o):
            raise NanInfError(name, "forward", detail=(
                f" (output {i}, shape {tuple(o.shape)}, {o.dtype})"))


def _check_backward(name: str, outs) -> None:
    """Hook the backward of each output: a non-finite gradient for the
    op's inputs raises, naming the op."""
    def hook(grad_inputs, grad_outputs):
        for i, g in enumerate(grad_inputs):
            if _nonfinite(g):
                raise NanInfError(name, "backward", detail=(
                    f" (input-grad {i}, shape {tuple(g.shape)}, {g.dtype})"))

    for fn in {o.grad_fn for o in outs
               if isinstance(o, torch.Tensor) and o.grad_fn is not None}:
        fn.register_hook(hook)


#: the ``static`` package once imported: its mode flag decides whether a
#: symbolic input is recorded (``static/program.py``)
_static = None


def recording(values) -> bool:
    """Static mode is on and one of ``values`` (torch tensors, or
    ``Tensor`` objects) is symbolic: the call is to be recorded into the
    default program, not run."""
    if _static is None or not _static._STATIC_MODE:
        return False
    for v in values:
        raw = getattr(v, "_data", v)
        if getattr(raw, "_static_var", None) is not None:
            return True
    return False


def apply(fn: Callable, raws: Sequence, name: Optional[str] = None):
    """Run ``fn`` on torch tensors ``raws`` (AMP-cast by ``name``) and wrap
    its result (a tensor, or a tuple/list of them) as ``Tensor``. In
    static mode a symbolic input records the call into the default
    program instead (before the AMP cast, as in the JAX package)."""
    from .tensor import Tensor

    if _static is not None and _static._STATIC_MODE and recording(raws):
        from ..static.program import record_apply

        out = record_apply(fn, raws, name)
        return tuple(out) if isinstance(out, (tuple, list)) else out
    raws = amp.cast_if_amp(name, raws)
    out = fn(*raws)
    multi = isinstance(out, (tuple, list))
    outs = tuple(out) if multi else (out,)
    if flag("check_nan_inf"):
        _check_forward(name or "op", outs)
        _check_backward(name or "op", outs)
    wrapped = tuple(Tensor._wrap(o) if isinstance(o, torch.Tensor) else o
                    for o in outs)
    return wrapped if multi else wrapped[0]


def _seeds(tensors, grad_tensors, what: str):
    from .tensor import to_torch

    if not isinstance(tensors, (list, tuple)):
        tensors = [tensors]
    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    if not isinstance(grad_tensors, (list, tuple)):
        grad_tensors = [grad_tensors]
    if len(grad_tensors) != len(tensors):
        raise ValueError(f"{what}: got {len(tensors)} tensors but "
                         f"{len(grad_tensors)} grad_tensors")
    raws = [to_torch(t) for t in tensors]
    seeds = [torch.ones_like(r) if g is None
             else torch.as_tensor(to_torch(g), dtype=r.dtype, device=r.device)
             for r, g in zip(raws, grad_tensors)]
    return raws, seeds


def run_backward(tensors, grad_tensors=None, retain_graph=False) -> None:
    """``loss.backward()``: accumulate gradients into the ``.grad`` of the
    leaves that require one (summed across calls until cleared). A
    non-scalar output is seeded with ones; an output that needs no
    gradient (``stop_gradient``) contributes nothing, as in the JAX
    package. A second pass over a graph without ``retain_graph``
    raises."""
    raws, seeds = _seeds(tensors, grad_tensors, "backward")
    live = [(r, s) for r, s in zip(raws, seeds) if r.requires_grad]
    if live:
        torch.autograd.backward([r for r, _ in live], [s for _, s in live],
                                retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, allow_unused=False):
    """paddle.grad: the gradients of ``outputs`` with respect to
    ``inputs`` as a list of ``Tensor`` (None for an unused input with
    ``allow_unused``; without it an unused input raises), leaving every
    ``.grad`` untouched. ``create_graph`` keeps the graph of the
    gradients, so they can be differentiated again."""
    from .tensor import Tensor, to_torch

    raws, seeds = _seeds(outputs, grad_outputs, "grad")
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    ins = [to_torch(t) for t in inputs]
    live = [i for i, r in enumerate(ins) if r.requires_grad]
    if len(live) < len(ins) and not allow_unused:
        raise RuntimeError(
            "One of the differentiated tensors does not require grad; pass "
            "allow_unused=True to return None for it")
    gs = torch.autograd.grad(
        raws, [ins[i] for i in live], seeds, retain_graph=retain_graph,
        create_graph=create_graph, allow_unused=allow_unused) if live else ()
    out = [None] * len(ins)
    for i, g in zip(live, gs):
        out[i] = None if g is None else Tensor._wrap(g)
    return out
