"""Carry ``paddle_tpu`` weights into the port.

``paddle_tpu`` stores a Linear weight as ``[in, out]``; the port's
``Linear`` holds PyTorch's ``[out, in]``. :func:`from_paddle_tpu_state`
turns a ``paddle_tpu`` ``TransformerLM.state_dict()`` (or bench.py's
GPT-medium model's: ``embed``, ``pos``, ``blocks.*``, ``head``), given as
numpy arrays, into a state dict the port's model's ``load_state_dict``
takes, so both packages compute the same function, and
:func:`to_paddle_tpu_state` turns the port's state back into paddle's
layout, so trained parameters compare in one layout. Parameter names are
the same in both packages.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["from_paddle_tpu_state", "to_paddle_tpu_state"]

#: the Linear layers of the models, whose weights are transposed
_LINEAR_WEIGHTS = ("attn.qkv.weight", "attn.out_proj.weight", "fc1.weight",
                   "fc2.weight", "head.weight")


def _is_linear_weight(name: str) -> bool:
    return any(name == s or name.endswith("." + s) for s in _LINEAR_WEIGHTS)


def from_paddle_tpu_state(np_state: Mapping[str, np.ndarray]
                          ) -> Dict[str, torch.Tensor]:
    """``{name: numpy array}`` of a ``paddle_tpu`` model -> ``{name: CPU
    tensor}`` in the port's layout (Linear weights transposed to
    ``[out, in]``; everything else as it is)."""
    out = {}
    for name, arr in np_state.items():
        a = np.asarray(arr)
        if _is_linear_weight(name):
            if a.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D [in, out] weight, "
                                 f"got shape {a.shape}")
            a = a.T
        out[name] = torch.from_numpy(np.ascontiguousarray(a))
    return out


def to_paddle_tpu_state(state: Mapping[str, torch.Tensor]
                        ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`from_paddle_tpu_state`: ``{name: tensor}`` of
    the port (a ``state_dict()``) -> ``{name: numpy array}`` in
    ``paddle_tpu``'s layout (Linear weights transposed to ``[in, out]``),
    copied, so later updates of the model do not show through."""
    out = {}
    for name, t in state.items():
        a = t.detach().cpu().numpy()
        # a copy: a CPU tensor's numpy() shares its storage
        out[name] = np.array(a.T if _is_linear_weight(name) else a)
    return out
