"""Token sampling for the decode loop (counterpart of
``paddle_tpu/serving/sampling.py``).

Small functions over ``[B, V]`` logits with per-slot ``[B]`` parameter
vectors, so one step serves requests with different settings:

- ``temperature <= 0`` -> greedy for that slot,
- ``top_k <= 0``       -> top-k filter off for that slot,
- ``top_p >= 1``       -> nucleus filter off for that slot.

Randomness comes from a ``torch.Generator`` the caller passes, in place of
the JAX key; nothing here reads the device back to the host. Top-k keeps
every logit >= the k-th largest (ties kept); top-p keeps the shortest
prefix of the descending-probability sort whose mass reaches p (the top
token always survives).
"""
from __future__ import annotations

import torch

__all__ = ["greedy", "apply_temperature", "top_k_mask", "top_p_mask",
           "sample"]


def _vec(v, n, dtype, device):
    return torch.as_tensor(v, dtype=dtype, device=device).expand(n)


def greedy(logits):
    """[B, V] logits -> [B] int32 argmax ids (first index on ties)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def apply_temperature(logits, temperature):
    """Divide each row by its temperature; non-positive entries clamp to a
    tiny epsilon (greedy rows are selected in :func:`sample`)."""
    t = _vec(temperature, logits.shape[0], logits.dtype, logits.device)
    return logits / torch.clamp(t, min=1e-6)[:, None]


def top_k_mask(logits, k):
    """Mask every logit strictly below its row's k-th largest to -inf;
    ``k <= 0`` leaves the row unfiltered."""
    V = int(logits.shape[-1])
    kk = _vec(k, logits.shape[0], torch.int64, logits.device)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    thr = torch.gather(sorted_desc, -1, (kk - 1).clamp(0, V - 1)[:, None])
    keep = (logits >= thr) | (kk <= 0)[:, None]
    return logits.masked_fill(~keep, float("-inf"))


def top_p_mask(logits, p):
    """Nucleus filter: keep the shortest prefix of the descending sort
    whose cumulative probability reaches ``p``; ``p >= 1`` leaves the row
    unfiltered."""
    pp = _vec(p, logits.shape[0], torch.float32, logits.device)
    order = torch.argsort(logits, dim=-1, descending=True)
    sorted_logits = torch.gather(logits, -1, order)
    probs = torch.softmax(sorted_logits.float(), dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep_sorted = (csum - probs) < pp[:, None]
    keep_sorted[..., 0] = True
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    keep = keep | (pp >= 1.0)[:, None]
    return logits.masked_fill(~keep, float("-inf"))


def sample(logits, generator=None, temperature=None, top_k=None,
           top_p=None):
    """One sampling step: ``[B, V]`` logits -> ``[B]`` int32 ids.

    Greedy rows (``temperature`` None, or <= 0 for the slot) take the
    argmax; the rest draw from the temperature-scaled, top-k- then
    top-p-filtered distribution (Gumbel-max with uniforms from
    ``generator``)."""
    g = greedy(logits)
    if temperature is None:
        return g
    lg = logits.float()
    t = _vec(temperature, lg.shape[0], torch.float32, lg.device)
    filtered = apply_temperature(lg, t)
    if top_k is not None:
        filtered = top_k_mask(filtered, top_k)
    if top_p is not None:
        filtered = top_p_mask(filtered, top_p)
    u = torch.rand(lg.shape, generator=generator, device=lg.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    drawn = torch.argmax(filtered + gumbel, dim=-1).to(torch.int32)
    return torch.where(t <= 0.0, g, drawn)
