"""Carry ``paddle_tpu`` weights into the port.

``paddle_tpu`` stores a Linear weight as ``[in, out]``; the port's
``Linear`` holds PyTorch's ``[out, in]``. Which entries are Linear weights
is read off the port's model: the ``weight`` of every module that is a
``nn.Linear`` of the port (the parallel linears and attention projections
included). Convolution weights (``[out, in / groups, kh, kw]`` in both
packages), batch norm's ``_mean`` and ``_variance`` and everything else
pass through unchanged. :func:`from_paddle_tpu_state` turns a
``paddle_tpu`` model's state (numpy arrays) into a state dict that the
port's model's ``load_state_dict`` takes, so both packages compute the
same function, and :func:`to_paddle_tpu_state` turns the port's state back
into paddle's layout, so trained parameters compare in one layout.
Parameter and buffer names are the same in both packages.
"""
from __future__ import annotations

from typing import Dict, Mapping, Set

import numpy as np
import torch

from .nn.layers.common import Linear

__all__ = ["from_paddle_tpu_state", "to_paddle_tpu_state"]


def _linear_weights(model: torch.nn.Module) -> Set[str]:
    """Names of the Linear weights of ``model`` (``fc.0.weight``,
    ``self_attn.qkv_proj.weight``, ...), whose layouts differ."""
    return {f"{name}.weight" if name else "weight"
            for name, m in model.named_modules() if isinstance(m, Linear)}


def from_paddle_tpu_state(np_state: Mapping[str, np.ndarray],
                          model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``{name: numpy array}`` of a ``paddle_tpu`` model -> ``{name: CPU
    tensor}`` in the layout of the port's ``model`` (its Linear weights
    transposed to ``[out, in]``; everything else as it is)."""
    linear = _linear_weights(model)
    out = {}
    for name, arr in np_state.items():
        a = np.asarray(arr)
        if name in linear:
            if a.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D [in, out] weight, "
                                 f"got shape {a.shape}")
            a = a.T
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def to_paddle_tpu_state(state: Mapping[str, torch.Tensor],
                        model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of :func:`from_paddle_tpu_state`: ``{name: tensor}`` of
    the port's ``model`` (its ``state_dict()``, or its gradients by
    parameter name) -> ``{name: numpy array}`` in ``paddle_tpu``'s layout
    (Linear weights transposed to ``[in, out]``), copied, so later updates
    of the model do not show through."""
    linear = _linear_weights(model)
    out = {}
    for name, t in state.items():
        a = t.detach().cpu().numpy()
        # a copy: a CPU tensor's numpy() shares its storage
        out[name] = np.array(a.T if name in linear else a)
    return out
