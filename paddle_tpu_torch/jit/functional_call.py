"""The Layer -> pure-function bridge (counterpart of
``paddle_tpu/jit/functional_call.py``).

Reference analog: PartialProgramLayer's parameter lifting and the
run_program op boundary (partial_program.py:206, run_program_op.cc): a
stateful Layer runs as a function of (params, buffers, inputs) ->
(outputs, new buffers).

Here the explicit state is put into the Layer's parameter and buffer
slots for the call (``torch.nn.utils.stateless``, tied weights tied) and
the Layer's own tensors are put back after it. The buffers the call
starts from are copies, so a buffer the Layer writes in place (batch
norm's running statistics) comes back in ``new_buffers`` and neither the
caller's tensors nor the Layer's are written. Gradients flow to the
parameters passed, through torch's autograd.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch.nn.utils.stateless import _reparametrize_module

from ..core import random as rnd
from ..core.tensor import Tensor

__all__ = ["functional_call", "named_state", "raw_state"]


def named_state(layer) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, buffers): name -> Parameter / buffer in traversal order."""
    return dict(layer.named_parameters()), dict(layer.named_buffers())


def raw_state(layer) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """Like :func:`named_state`, with detached torch tensors as values."""
    params, buffers = named_state(layer)
    return ({k: p.detach() for k, p in params.items()},
            {k: b.detach() for k, b in buffers.items()})


@contextlib.contextmanager
def _seeded(key):
    """Draws of the package's generators inside come from generators
    seeded with ``key`` (an int), so the call's randomness is a function
    of it; the package's generators are put back after."""
    if key is None:
        yield
        return
    saved = dict(rnd._generators)
    try:
        for dev in list(saved) or [None]:
            from ..core.device import resolve_device

            d = resolve_device(dev)
            rnd._generators[d] = rnd.generator(int(key), d)
        yield
    finally:
        rnd._generators.clear()
        rnd._generators.update(saved)


def _raw(v):
    return v._data if isinstance(v, Tensor) else v


def _wrap_in(x):
    if isinstance(x, Tensor):
        return x
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x)
    return x


def functional_call(layer, params: Dict[str, Any],
                    buffers: Optional[Dict[str, Any]] = None,
                    args: Sequence = (), kwargs: Optional[Dict] = None, *,
                    key=None):
    """Run ``layer`` purely: explicit state in, raw outputs and new
    buffers out.

    ``params`` / ``buffers`` map state names (as ``named_parameters`` /
    ``named_buffers`` give them) to torch tensors or ``Tensor``; a missing
    buffer defaults to the Layer's current value, a missing parameter
    raises ``KeyError``. Returns ``(out, new_buffers)``: ``out`` mirrors
    the Layer's return structure with torch tensors in place of ``Tensor``,
    ``new_buffers`` holds every buffer's value after the call. ``key`` (an
    int) makes the call's random draws (dropout) a function of it."""
    kwargs = kwargs or {}
    p_named, b_named = named_state(layer)
    state = {}
    for name in p_named:
        if name not in params:
            raise KeyError(f"functional_call: missing parameter '{name}'")
        state[name] = _raw(params[name])
    for name, b in b_named.items():
        v = buffers[name] if buffers is not None and name in buffers else b
        state[name] = _raw(v).detach().clone()
    with _seeded(key), _reparametrize_module(layer, state, tie_weights=True):
        out = layer(*[_wrap_in(a) for a in args], **kwargs)
        new_buffers = dict(layer.named_buffers())
    out = pytree.tree_map(_raw, out,
                          is_leaf=lambda v: isinstance(v, Tensor))
    return out, new_buffers
