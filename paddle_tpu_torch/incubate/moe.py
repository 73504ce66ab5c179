"""Mixture-of-Experts with expert parallelism, GShard-style (counterpart of
``paddle_tpu/incubate/moe.py``).

Routing is GShard's dense dispatch: top-2 gating builds a dispatch mask
``[N, E, C]`` (static capacity C; a token past its expert's capacity
drops), and two einsums move the tokens to the experts and back.
``_top2_dispatch`` keeps the JAX package's choices exactly, since a token
routed elsewhere is not a rounding difference: ``argmax`` takes the first
index of a tie, the second choice masks the first, a token's place in its
expert's buffer is the cumulative count over the flattened tokens (first
choices ahead of all second choices), and ``C = max(ceil(2 N / E * cf),
1)``.

**Expert parallelism** (a rank is a process, ``distributed/comm.py``): the
expert weights ``[E, ...]`` are cut over the hybrid mesh's
``expert_axis`` (mp by default), ``E / ep`` experts a rank, as the JAX
package's ``_shard_param`` lays them out. Every rank of that group holds
the same tokens and gates them alike; it takes its experts' rows of the
dispatched buffer (whose backward gathers every rank's rows), runs its
experts, and the experts' outputs are all-gathered (whose backward takes
its rows back) before the combine: the all-to-all that GSPMD inserts in
the JAX package is this gather here. ``set_state_dict`` takes the full
``[E, ...]`` arrays and keeps this rank's experts; ``full_state_dict``
(``distributed.meta_parallel``) gathers them back. The layer's products
are plain torch (the JAX package's are jnp outside any Pallas kernel).
"""
from __future__ import annotations

import math

import torch

from ..distributed import comm
from ..nn.initializer import XavierNormal
from ..nn.layer import Layer

__all__ = ["ExpertParallelMoE", "moe_dispatch_combine"]


def _one_hot(idx, n, dtype):
    return torch.nn.functional.one_hot(idx, n).to(dtype)


def _top2_dispatch(gates, capacity):
    """gates ``[N, E]`` -> (dispatch ``[N, E, C]`` 0/1, combine ``[N, E,
    C]``, the first choices ``[N, E]``).

    GShard top-2: per token, the best and second-best expert; tokens past
    an expert's capacity drop. Position within each expert's buffer is the
    token's rank among that expert's assignees (cumsum over the flattened
    token axis: deterministic, order-of-arrival priority)."""
    N, E = gates.shape
    C = capacity
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = _one_hot(idx1, E, gates.dtype)
    gates2 = gates * (1.0 - mask1)
    idx2 = torch.argmax(gates2, dim=-1)
    mask2 = _one_hot(idx2, E, gates.dtype)
    # positions: first-choice tokens take priority over second choices
    pos1 = torch.cumsum(mask1, dim=0) - mask1
    count1 = mask1.sum(dim=0, keepdim=True)
    pos2 = torch.cumsum(mask2, dim=0) - mask2 + count1
    keep1 = mask1 * (pos1 < C)
    keep2 = mask2 * (pos2 < C)
    g1 = (gates * keep1).sum(-1)
    g2 = (gates * keep2).sum(-1)
    denom = torch.clamp(g1 + g2, min=1e-9)
    g1, g2 = g1 / denom, g2 / denom
    oh1 = _one_hot(torch.clamp((pos1 * mask1).sum(-1), 0, C - 1).long(), C,
                   gates.dtype)
    oh2 = _one_hot(torch.clamp((pos2 * mask2).sum(-1), 0, C - 1).long(), C,
                   gates.dtype)
    disp = (keep1[:, :, None] * oh1[:, None, :]
            + keep2[:, :, None] * oh2[:, None, :])
    comb = (g1[:, None, None] * keep1[:, :, None] * oh1[:, None, :]
            + g2[:, None, None] * keep2[:, :, None] * oh2[:, None, :])
    return disp, comb, mask1


def moe_dispatch_combine(x, gates, capacity):
    """Functional GShard routing for testing: x ``[N, M]``, gates ``[N,
    E]`` -> (expert_inputs ``[E, C, M]``, combine ``[N, E, C]``, dispatch
    ``[N, E, C]``)."""
    disp, comb, _ = _top2_dispatch(gates, capacity)
    expert_in = torch.einsum("nec,nm->ecm", disp, x)
    return expert_in, comb, disp


class ExpertParallelMoE(Layer):
    """Expert-parallel MoE FFN block.

    The experts' weights ``[E, ...]`` are cut over ``expert_axis`` of the
    hybrid mesh when E divides by its size (else every rank holds all).
    Capacity is ``ceil(2 * tokens / E * capacity_factor)``.

    ``forward(x)`` -> ``(out, aux_loss)``: aux_loss is the GShard
    load-balancing term ``E * sum_e f_e p_e``, differentiable through the
    gates."""

    def __init__(self, d_model, d_hidden, num_experts, k=2,
                 capacity_factor=1.25, expert_axis="mp", mesh=None,
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        if k != 2:
            raise NotImplementedError("top-2 gating only (GShard default)")
        self.num_experts = E = int(num_experts)
        self.capacity_factor = float(capacity_factor)
        self.expert_axis = expert_axis
        self.mesh = mesh if mesh is not None else comm.hybrid_mesh()
        kw = dict(default_initializer=XavierNormal(), device=device,
                  generator=generator)
        self.gate = self.create_parameter([d_model, E], **kw)
        self.wi = self.create_parameter([E, d_model, d_hidden], **kw)
        self.wo = self.create_parameter([E, d_hidden, d_model], **kw)
        self._shard = None
        m = self.mesh
        if m is not None and expert_axis in m.shape \
                and m.shape[expert_axis] > 1 \
                and E % m.shape[expert_axis] == 0:
            from ..distributed.meta_parallel import _Shard, _mark

            n, r = int(m.shape[expert_axis]), m.axis_rank(expert_axis)
            g = m.group(expert_axis)
            self._shard = _Shard((), 0, n, r, g)
            # every rank drew the same full weights; each keeps its experts
            for p in (self.wi, self.wo):
                full = tuple(p.shape)
                p.data = _Shard(full, 0, n, r, g).take(p.data).contiguous()
                _mark(p, _Shard(full, 0, n, r, g))

    def forward(self, x):
        """x ``[B, S, M]`` -> (out ``[B, S, M]``, aux_loss scalar)."""
        from ..distributed.meta_parallel import _GatherFromMP, _ScatterToMP

        E = self.num_experts
        B, S, M = x.shape
        N = B * S
        C = max(int(math.ceil(2 * N / E * self.capacity_factor)), 1)
        xf = x.reshape(N, M)
        logits = xf.float() @ self.gate.float()
        gates = torch.softmax(logits, dim=-1)
        disp, comb, mask1 = _top2_dispatch(gates, C)
        expert_in = torch.einsum("nec,nm->ecm", disp.to(x.dtype), xf)
        if self._shard is not None:
            expert_in = _ScatterToMP.apply(expert_in, self._shard)
        h = torch.nn.functional.gelu(torch.einsum(
            "ecm,emh->ech", expert_in, self.wi.to(expert_in.dtype)),
            approximate="tanh")
        expert_out = torch.einsum("ech,ehm->ecm", h, self.wo.to(h.dtype))
        if self._shard is not None:
            expert_out = _GatherFromMP.apply(expert_out, self._shard)
        out = torch.einsum("nec,ecm->nm", comb.to(x.dtype), expert_out)
        # load balancing (GShard aux): E * mean(fraction routed) * mean(gate
        # prob) per expert
        f_e = mask1.mean(dim=0)
        p_e = gates.mean(dim=0)
        aux = (f_e * p_e).sum() * E
        return out.reshape(B, S, M), aux.to(x.dtype)
