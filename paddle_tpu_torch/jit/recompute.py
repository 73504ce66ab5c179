"""Activation recomputation (counterpart of ``paddle_tpu/jit/recompute.py``).

Reference: RecomputeOptimizer (python/paddle/fluid/optimizer.py:4549) and
fleet recompute (meta_optimizers/recompute_optimizer.py:18: re-emit the
forward subgraphs in backward via append_backward(checkpoints)).

Here the segment runs under ``torch.utils.checkpoint.checkpoint(
use_reentrant=False)``: its activations are dropped after the forward and
the segment runs again in backward, launching its forward kernels again,
trading device time for memory (the JAX package's ``jax.checkpoint``).
The parameters of the Layers the segment touches are found as the JAX
package finds them and enter the checkpoint as explicit inputs, so their
gradients flow. The random state is preserved: the package's generators
and a world's named streams (``core.random.get_states``) and, through
``preserve_rng_state``, PyTorch's are set back to their state at the
forward before the recomputation, so dropout draws the same masks twice.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..core import random as rnd
from ..core.tensor import Tensor
from ..nn.layer import Layer
from .program import _collect_layers, _State

__all__ = ["recompute"]


def recompute(function, *args, preserve_rng_state=True, **kwargs):
    """paddle.distributed.fleet.utils.recompute: ``function(*args,
    **kwargs)`` with its activations recomputed in backward. ``function``
    may be a Layer, a bound Layer method, or a function closing over
    Layers."""
    owner, fn = None, function
    if isinstance(function, Layer):
        owner, fn = function, function.forward
    elif isinstance(getattr(function, "__self__", None), Layer):
        owner = function.__self__
    state = _State(_collect_layers(owner, fn))
    tensor_args = [a for a in args if isinstance(a, (Tensor, torch.Tensor))]
    template = [("t", None) if isinstance(a, (Tensor, torch.Tensor))
                else ("c", a) for a in args]
    n_in, n_p = len(tensor_args), len(state.params)
    at_forward = rnd.get_states() if preserve_rng_state else None
    runs = [0]
    treedef = []

    def segment(*raws):
        it = iter(raws[:n_in])
        rebuilt = [Tensor._wrap(next(it)) if kind == "t" else const
                   for kind, const in template]
        later = None
        if runs[0] and at_forward is not None:
            # the recomputation: the forward's draws
            later = rnd.get_states()
            rnd.set_states(at_forward)
        runs[0] += 1
        saved = state.swap(raws[n_in:n_in + n_p], state.buffers)
        try:
            out = fn(*rebuilt, **kwargs)
        finally:
            state.restore(saved)
            if later is not None:
                rnd.set_states(later)
        if isinstance(out, (list, tuple)):
            treedef[:] = [type(out)]
            return tuple(o._data if isinstance(o, Tensor) else o
                         for o in out)
        treedef[:] = [None]
        return out._data if isinstance(out, Tensor) else out

    raws = [a._data if isinstance(a, Tensor) else a for a in tensor_args]
    out = checkpoint(segment, *raws, *state.params, use_reentrant=False,
                     preserve_rng_state=preserve_rng_state)
    if treedef[0] is None:
        return Tensor._wrap(out) if isinstance(out, torch.Tensor) else out
    return treedef[0](Tensor._wrap(o) if isinstance(o, torch.Tensor) else o
                      for o in out)
