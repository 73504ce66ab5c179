"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``).

``cross_entropy``: softmax + NLL over ``input`` logits, or over
``log(max(input, 1e-30))`` with ``use_softmax=False``; hard labels (with
``ignore_index`` and class ``weight``: the mean divides by the sum of the
kept rows' weights) or soft labels (``-sum(label * logp)`` per row; the
weight is not applied there, as in the JAX package). Under AMP its
logits are cast to float32 first (black list).

The other losses follow the JAX package's formulas: ``kl_div`` means over
every element by default (``"batchmean"`` divides by the batch), ``bce``
clamps its logs at 1e-12, ``ctc_loss`` takes ``[T, N, C]`` log-probs and
divides each sample's loss by its label length under ``"mean"`` (its
``norm_by_times`` is taken and has no effect, as there),
``sigmoid_focal_loss`` divides by ``normalizer`` before the reduction.

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

__all__ = [
    "cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "mse_loss", "l1_loss", "nll_loss",
    "kl_div", "smooth_l1_loss", "margin_ranking_loss",
    "hinge_embedding_loss", "cosine_embedding_loss", "ctc_loss",
    "square_error_cost", "sigmoid_focal_loss", "log_loss", "npair_loss",
    "triplet_margin_loss", "fused_linear_cross_entropy",
]


def _reduce(v, reduction):
    if reduction == "mean":
        return v.mean()
    if reduction == "sum":
        return v.sum()
    if reduction == "none":
        return v
    raise ValueError(f"unknown reduction {reduction!r}")


def _pick(logp, label, axis, ignore_index, weight, reduction):
    """-logp at each integer label along ``axis``, zero where the label is
    ``ignore_index``, weighted by ``weight[label]``; "mean" divides by the
    kept rows' weight (their count, at least 1, without weights)."""
    li = label
    if li.dim() == logp.dim():  # (N, 1) hard labels
        li = li.squeeze(axis)
    li = li.to(torch.int64)
    valid = li != ignore_index
    safe = torch.where(valid, li, torch.zeros_like(li))
    loss = -torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if weight is not None:
            return loss.sum() / (weight[safe] * valid).sum()
        return loss.sum() / valid.sum().clamp(min=1)
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """paddle.nn.functional.cross_entropy over ``input`` (logits, or
    probabilities with ``use_softmax=False``) and ``label``: integer class
    labels (``input``'s shape without ``axis``, or with a trailing 1
    there), or with ``soft_label`` a distribution of ``input``'s shape."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    (input,) = amp.cast_if_amp("cross_entropy", (input,))
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(torch.clamp(input, min=1e-30))
    if soft_label:
        return _reduce(-(label * logp).sum(dim=axis), reduction)
    return _pick(logp, label, axis, ignore_index, weight, reduction)


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
    return _reduce(rows, reduction)


def square_error_cost(input, label):
    return (input - label) ** 2


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label) ** 2, reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).abs(), reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """``-(y log p + (1 - y) log(1 - p))``, each log of at least 1e-12."""
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, min=eps))
             + (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """The stable ``max(z, 0) - z y + log(1 + exp(-|z|))``; with
    ``pos_weight``, ``-(pos_weight y log sigmoid(z) + (1 - y) log(1 -
    sigmoid(z)))``."""
    sp = torch.nn.functional.softplus
    if pos_weight is None:
        loss = torch.clamp(logit, min=0) - logit * label \
            + torch.log1p(torch.exp(-logit.abs()))
    else:
        loss = -(pos_weight * label * -sp(-logit) + (1 - label) * -sp(logit))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100,
             reduction="mean", name=None):
    """Negative log-likelihood of ``[N, C]`` log-probabilities at the
    ``[N]`` labels, with ``cross_entropy``'s ``ignore_index``, ``weight``
    and "mean"."""
    return _pick(input, label, 1, ignore_index, weight, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """``label * (log(max(label, 1e-12)) - input)`` with ``input`` the
    log-probabilities; "mean" over every element, "batchmean" over the
    first axis."""
    loss = label * (torch.log(torch.clamp(label, min=1e-12)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = (input - label).abs()
    return _reduce(torch.where(d < delta, 0.5 * d * d / delta,
                               d - 0.5 * delta), reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp(margin - input, min=0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    norm = torch.linalg.vector_norm
    cos = (input1 * input2).sum(-1) / torch.clamp(
        norm(input1, dim=-1) * norm(input2, dim=-1), min=1e-12)
    return _reduce(torch.where(label == 1, 1 - cos,
                               torch.clamp(cos - margin, min=0.0)),
                   reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return -label * torch.log(input + epsilon) \
        - (1 - label) * torch.log(1 - input + epsilon)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """``a_t (1 - p_t)^gamma ce`` per element, divided by ``normalizer``
    when given, then reduced (a sum by default)."""
    p = torch.sigmoid(logit)
    ce = torch.clamp(logit, min=0) - logit * label \
        + torch.log1p(torch.exp(-logit.abs()))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * (1 - p_t) ** gamma * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.t()
    lbl = labels.reshape(-1)
    tgt = (lbl[:, None] == lbl[None, :]).to(sim.dtype)
    tgt = tgt / tgt.sum(dim=1, keepdim=True)
    xent = -(tgt * torch.log_softmax(sim, dim=1)).sum(dim=1).mean()
    reg = l2_reg * ((anchor * anchor).sum(1).mean()
                    + (positive * positive).sum(1).mean()) * 0.25
    return xent + reg


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    norm = torch.linalg.vector_norm
    dp = norm(input - positive + epsilon, ord=p, dim=-1)
    dn = norm(input - negative + epsilon, ord=p, dim=-1)
    if swap:
        dn = torch.minimum(dn, norm(positive - negative + epsilon, ord=p,
                                    dim=-1))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the alpha recursion in log space over ``[T, N, C]``
    log-probs and ``[N, S]`` padded labels (the JAX package's scan): each
    sample's loss is ``-log`` of the paths ending at its input length;
    "mean" averages ``loss / label_length``."""
    T, N, C = log_probs.shape
    lbl = labels.long()
    in_len, lab_len = input_lengths.long(), label_lengths.long()
    S = lbl.shape[1]
    neg = -1e30
    dev = log_probs.device
    ext = torch.full((N, 2 * S + 1), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lbl
    rows = torch.arange(N, device=dev)
    alpha = torch.full((N, 2 * S + 1), neg, dtype=log_probs.dtype,
                       device=dev)
    alpha = torch.cat([log_probs[0, rows, blank][:, None],
                       log_probs[0, rows, ext[:, 1]][:, None],
                       alpha[:, 2:]], dim=1)
    same = ext[:, 2:] == ext[:, :-2]
    pad1 = torch.full((N, 1), neg, dtype=log_probs.dtype, device=dev)
    traj = [alpha]
    for t in range(1, T):
        a1 = torch.cat([pad1, alpha[:, :-1]], 1)
        a2 = torch.cat([pad1, pad1, torch.where(same, torch.full_like(
            alpha[:, :-2], neg), alpha[:, :-2])], 1)
        merged = torch.logaddexp(torch.logaddexp(alpha, a1), a2)
        alpha = merged + torch.gather(log_probs[t], 1, ext)
        traj.append(alpha)
    traj = torch.stack(traj)  # T, N, 2S+1
    last = traj[torch.clamp(in_len - 1, 0, T - 1), rows]
    end1 = torch.gather(last, 1, (2 * lab_len)[:, None])[:, 0]
    end2 = torch.gather(last, 1, torch.clamp(2 * lab_len - 1, min=0)[:, None])[:, 0]
    loss = -torch.logaddexp(end1, end2)
    if reduction == "mean":
        return (loss / torch.clamp(lab_len, min=1)).mean()
    return _reduce(loss, reduction)
