"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

``cross_entropy`` with hard labels: softmax + NLL, mean over the rows
whose label is not ``ignore_index`` (divided by at least 1). Soft labels,
class weights and ``use_softmax=False`` raise. Under AMP its logits are
cast to float32 first (black list).

``fused_linear_cross_entropy``: the LM head's projection and the softmax
cross-entropy in one pass over vocab chunks, so the ``[N, V]`` float32
logits and their gradient exist one chunk at a time (the JAX package's
``_fused_linear_ce`` custom_vjp, here a ``torch.autograd.Function``).
"""
from __future__ import annotations

import os

import torch

from ... import amp
from .common import linear

__all__ = ["cross_entropy", "fused_linear_cross_entropy"]


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
    (input,) = amp.cast_if_amp("cross_entropy", (input,))
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


# the running max before any column is seen (the JAX package's masking
# value of padded vocab columns)
_CE_NEG = -1e30


def _ce_chunk_default() -> int:
    """``PADDLE_CE_CHUNK``, default 8192 (0 or less: the dense route)."""
    try:
        return int(os.environ.get("PADDLE_CE_CHUNK", "8192") or 0)
    except ValueError:
        return 8192


def _chunk_logits(h32, w, b, lo, hi):
    """float32 logits of vocab columns ``lo:hi``: ``h @ w[:, lo:hi] +
    b[lo:hi]``, the product taken in float32 whatever the inputs' type
    (the JAX package's ``preferred_element_type=float32``)."""
    logits = torch.matmul(h32, w[:, lo:hi].float())
    if b is not None:
        logits = logits + b[lo:hi].float()
    return logits


class FusedLinearCEFunction(torch.autograd.Function):
    """Per-row loss ``[N]`` of softmax cross-entropy over ``h @ w + b``,
    streamed over vocab chunks of width ``chunk``: an online logsumexp in
    the forward, and a backward that recomputes each chunk's softmax from
    the saved lse. The tail chunk is cut to the vocab (``w[lo:V]``) where
    the JAX package pads the weight and masks the padded columns with
    ``_CE_NEG``; both give every column past V no weight in the sum.
    ``w`` is ``[d, V]``."""

    @staticmethod
    def forward(ctx, h, w, b, labels, chunk, ignore_index):
        N, V = h.shape[0], w.shape[1]
        labels = labels.to(torch.int64)
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        h32 = h.float()
        m = torch.full((N,), _CE_NEG, device=h.device, dtype=torch.float32)
        l = torch.zeros(N, device=h.device, dtype=torch.float32)
        picked = torch.zeros(N, device=h.device, dtype=torch.float32)
        for lo in range(0, V, chunk):
            hi = min(lo + chunk, V)
            logits = _chunk_logits(h32, w, b, lo, hi)
            rel = safe - lo
            inside = (rel >= 0) & (rel < hi - lo)
            p = torch.gather(logits, 1, rel.clamp(0, hi - lo - 1)[:, None])
            picked = torch.where(inside, p[:, 0], picked)
            m_new = torch.maximum(m, logits.max(dim=1).values)
            l = l * torch.exp(m - m_new) \
                + torch.exp(logits - m_new[:, None]).sum(dim=1)
            m = m_new
        lse = m + torch.log(l)
        ctx.save_for_backward(h, w, b, labels, lse)
        ctx.chunk, ctx.ignore_index = chunk, ignore_index
        return torch.where(valid, lse - picked, torch.zeros_like(lse))

    @staticmethod
    def backward(ctx, g):
        h, w, b, labels, lse = ctx.saved_tensors
        chunk, V = ctx.chunk, w.shape[1]
        valid = labels != ctx.ignore_index
        geff = torch.where(valid, g.float(), torch.zeros_like(lse))
        h32 = h.float()
        dh = torch.zeros_like(h32)
        dw = torch.empty_like(w)
        db = torch.empty_like(b) if b is not None else None
        for lo in range(0, V, chunk):
            hi = min(lo + chunk, V)
            p = torch.exp(_chunk_logits(h32, w, b, lo, hi) - lse[:, None])
            rel = labels - lo
            hit = valid & (rel >= 0) & (rel < hi - lo)
            # softmax - onehot, with no host read of which rows hit
            p.scatter_add_(1, rel.clamp(0, hi - lo - 1)[:, None],
                           -hit.to(p.dtype)[:, None])
            s = p * geff[:, None]
            dh += torch.matmul(s, w[:, lo:hi].float().t())
            dw[:, lo:hi] = torch.matmul(h32.t(), s).to(w.dtype)
            if db is not None:
                db[lo:hi] = s.sum(dim=0).to(b.dtype)
        return dh.to(h.dtype), dw, db, None, None, None


def fused_linear_cross_entropy(input, weight, bias=None, label=None,
                               chunk=None, ignore_index=-100,
                               reduction="mean", name=None):
    """Softmax cross-entropy of ``input @ weight + bias`` against
    ``label``, streamed over vocab chunks of width ``chunk`` (default
    ``PADDLE_CE_CHUNK``, 8192). ``input`` is the pre-head hidden state
    ``[N, d]``; ``weight`` is the head's weight in paddle's layout,
    ``[d, V]``, ``bias`` ``[V]``; pass ``model.head.weight`` and
    ``model.head.bias``, which get their gradients through the op. Labels
    are ``[N]`` or ``[N, 1]``; rows labelled ``ignore_index`` count for
    nothing. ``chunk <= 0`` or ``chunk >= V`` is the dense route:
    ``linear`` then ``cross_entropy``. On neither AMP list: the hidden
    state comes in its own type, and the chunk products run in float32."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(
            f"fused_linear_cross_entropy: unknown reduction {reduction!r}")
    chunk = _ce_chunk_default() if chunk is None else int(chunk)
    V = int(weight.shape[1])
    if chunk <= 0 or chunk >= V:
        return cross_entropy(linear(input, weight, bias), label,
                             ignore_index=ignore_index, reduction=reduction)
    li = label.squeeze(-1) if label.dim() == 2 else label
    rows = FusedLinearCEFunction.apply(input, weight, bias, li, chunk,
                                       ignore_index)
    if reduction == "mean":
        return rows.sum() / (li != ignore_index).sum().clamp(min=1)
    if reduction == "sum":
        return rows.sum()
    return rows
