"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

Only ``cross_entropy`` with hard labels is ported so far: softmax + NLL,
mean over the rows whose label is not ``ignore_index`` (divided by at
least 1). Soft labels, class weights and ``use_softmax=False`` raise.
"""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """paddle.nn.functional.cross_entropy over ``input`` logits with
    integer class labels (shape of ``input`` without ``axis``, or with a
    trailing 1 there)."""
    if weight is not None or soft_label or not use_softmax:
        raise NotImplementedError(
            "cross_entropy: class weights, soft labels and use_softmax=False "
            "are not ported yet")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    logp = torch.log_softmax(input, dim=axis)
    li = label
    if li.dim() == logp.dim():  # (N, 1) hard labels
        li = li.squeeze(axis)
    li = li.to(torch.int64)
    valid = li != ignore_index
    safe = torch.where(valid, li, torch.zeros_like(li))
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1)
    if reduction == "sum":
        return loss.sum()
    return loss
