"""Single-token decode step, bucketed prefill, the speculative round and
the migrated-KV insert (counterpart of ``paddle_tpu/jit/decode_step.py``'s
``DecodeState``, ``DecodeStep``, ``PrefillStep``, ``SpecDecodeState``,
``SpeculativeDecodeStep`` and ``MigrateInsert``).

PyTorch runs them eagerly: where the JAX package compiles one program per
step, each step here is the same sequence of kernel launches. The loop
state (``DecodeState``) lives on the device: tokens, positions, done
flags, budgets and the sampling generator never visit the host between
steps, and nothing in a step reads the device back. Stop conditions fold
into the step: a slot whose token hits its ``eos`` id, or whose budget
runs out, flips ``done`` and emits the sentinel ``-1`` from then on.

Env knob, with the JAX package's meaning: ``PADDLE_SERVE_SPEC_K`` -- draft
tokens per speculative round (4; at least 1).
"""
from __future__ import annotations

import os

import torch

from ..core.random import generator as make_generator

__all__ = ["NO_BUDGET", "DecodeState", "DecodeStep", "PrefillStep",
           "MigrateInsert", "spec_k_default", "SpecDecodeState",
           "SpeculativeDecodeStep"]

#: effectively unbounded per-slot step budget (the host loop bounds it)
NO_BUDGET = 1 << 30


def _cache_device(caches) -> torch.device:
    """The device of a model's cache list (contiguous or paged, float or
    quantized: the first tensor of the first layer's K)."""
    k = caches[0].k
    while isinstance(k, tuple):  # PagedKV(kv, table), QuantKV(q, scale)
        k = k[0]
    return k.device


def _uses_adapters(model) -> bool:
    """Does ``model`` carry an adapter fleet? Read once, when a step is
    built, as the JAX package fixes it in the compiled step."""
    return getattr(model, "_serve_adapters", None) is not None


class DecodeState:
    """Device-resident decode loop state.

    caches    : per-layer ``MultiHeadAttention.Cache`` (static shapes)
    pos       : [B] int32 — next write position per slot
    tok       : [B] int32 — token to feed the model this step
    done      : [B] bool  — slot finished (eos / budget / host-marked)
    generator : ``torch.Generator`` on the device, threaded through
                sampling
    temperature/top_k/top_p : [B] per-slot sampling parameters
    eos       : [B] int32 — stop token per slot (-1 = none)
    budget    : [B] int32 — remaining decode STEPS per slot
    adapter   : [B] int32 — per-slot adapter id (0 = the base model; read
                only when the model carries a ``serving.adapters
                .AdapterSet``)
    """

    FIELDS = ("caches", "pos", "tok", "done", "generator", "temperature",
              "top_k", "top_p", "eos", "budget", "adapter")
    __slots__ = FIELDS

    def __init__(self, caches, pos, tok, done, generator, temperature,
                 top_k, top_p, eos, budget, adapter=None):
        self.caches = caches
        self.pos = pos
        self.tok = tok
        self.done = done
        self.generator = generator
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos = eos
        self.budget = budget
        self.adapter = (adapter if adapter is not None
                        else torch.zeros_like(pos))

    @classmethod
    def make(cls, caches, first_tokens, pos, *, seed=0, temperature=0.0,
             top_k=0, top_p=1.0, eos_id=None, budget=None, adapter=0):
        """A fresh state on the caches' device (one host-to-device copy).
        Scalars broadcast to [B]. ``budget`` is the remaining step count
        per slot after the first token (None = unbounded)."""
        dev = _cache_device(caches)
        tok = torch.as_tensor(first_tokens, dtype=torch.int32, device=dev)
        B = int(tok.shape[0])

        def vec(v, dtype):
            return torch.as_tensor(v, dtype=dtype, device=dev) \
                .expand(B).clone()

        return cls(
            caches=caches,
            pos=torch.as_tensor(pos, dtype=torch.int32, device=dev),
            tok=tok,
            done=torch.zeros(B, dtype=torch.bool, device=dev),
            generator=make_generator(seed, dev),
            temperature=vec(temperature, torch.float32),
            top_k=vec(top_k, torch.int32),
            top_p=vec(top_p, torch.float32),
            eos=vec(-1 if eos_id is None else eos_id, torch.int32),
            budget=vec(NO_BUDGET if budget is None else budget,
                       torch.int32),
            adapter=vec(adapter, torch.int32),
        )


class DecodeStep:
    """One single-token step of the decode loop::

        step = DecodeStep(model)
        emitted, logits, state = step(state)   # all on the device

    ``emitted`` is [B] int32 with ``-1`` for slots already done; ``logits``
    is the [B, V] f32 distribution this step sampled from. The caches are
    written in place. A model with an ``AdapterSet`` attached when the step
    is built gets the state's per-slot adapter ids; any other model's call
    is unchanged."""

    def __init__(self, model):
        self.model = model
        self._use_adapters = _uses_adapters(model)

    @torch.no_grad()
    def __call__(self, state: DecodeState):
        from ..serving import sampling  # serving imports this module

        kw = {"adapter": state.adapter} if self._use_adapters else {}
        logits, caches = self.model(state.tok[:, None], cache=state.caches,
                                    pos=state.pos, **kw)
        last = logits[:, -1, :].float()
        nxt = sampling.sample(last, state.generator, state.temperature,
                              state.top_k, state.top_p)
        live = (~state.done).to(torch.int32)
        # this step's token spends one unit of the slot's budget; both stop
        # conditions fold into the done mask on the device
        budget = state.budget - live
        done = state.done | (nxt == state.eos) | (budget <= 0)
        emit = torch.where(state.done, -1, nxt)
        # done slots keep feeding token 0 at a frozen position: their cache
        # writes land on the same dead row
        feed = torch.where(done, 0, nxt)
        pos = state.pos + live
        return emit, last, DecodeState(
            caches, pos, feed, done, state.generator, state.temperature,
            state.top_k, state.top_p, state.eos, budget, state.adapter)


class PrefillStep:
    """Bucketed prefill: right-padded ``[B, L]`` prompt ids write their K/V
    rows at positions ``start .. start+L-1`` and the logits of each row's
    last REAL token come back (the first sampling input). Padding rows
    write garbage past each row's length, which the position mask hides
    and the decode overwrites before any query can see it. ``start`` ([B],
    default zeros) writes a chunk after history already in the cache:
    chunked prefill, and the tail of a shared prefix."""

    def __init__(self, model):
        self.model = model
        self._use_adapters = _uses_adapters(model)
        self._n_steps = 0

    @torch.no_grad()
    def __call__(self, caches, ids, lengths, start=None, adapter=None):
        """-> (last_logits [B, V] f32, caches, pos [B] = start + lengths).
        ``adapter``: per-row adapter ids (default zeros, the base model).
        """
        dev = _cache_device(caches)
        ids = torch.as_tensor(ids, dtype=torch.int64, device=dev)
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        B, L = int(ids.shape[0]), int(ids.shape[1])
        start = (torch.zeros(B, dtype=torch.int32, device=dev)
                 if start is None else
                 torch.as_tensor(start, dtype=torch.int32, device=dev))
        kw = {}
        if self._use_adapters:
            kw["adapter"] = (torch.zeros(B, dtype=torch.int32, device=dev)
                             if adapter is None else torch.as_tensor(
                                 adapter, dtype=torch.int32, device=dev))
        self._n_steps += 1
        logits, caches = self.model(ids, cache=caches, pos=start, **kw)
        idx = (lengths.to(torch.int64) - 1).clamp(0, L - 1)
        last = torch.gather(
            logits, 1, idx[:, None, None].expand(B, 1, logits.shape[-1]))
        return last[:, 0, :].float(), caches, start + lengths


class MigrateInsert:
    """Insert with history: splice a migrated KV bundle's block rows into a
    paged pool slot and reset that slot's state entries to the source's
    mid-decode values::

        MigrateInsert()(state, rows, slot, table_row, ctx=, last_tok=,
                        temperature=, top_k=, top_p=, eos_id=, budget=,
                        adapter=)

    Where the engine's prefill insert writes a fresh cache at position 0
    with a first sampled token, this writes ``ctx`` rows of decode history
    and feeds the source's last emitted token at position ``ctx``: the
    next ``DecodeStep`` continues the sequence as if the request had never
    moved, with no ``PrefillStep`` work.

    ``rows`` is a list over the cache's ``PagedKV`` buffers (layer by
    layer, K then V), each the bundle's rows zero-padded to the table
    width, ``[nmax, H, bs, D]``: a ``(payload,)`` tuple, or ``(payload,
    scales)`` for a quantized pool, adopted narrow
    (``paged_kv.paged_adopt``). ``table_row`` ([nmax] int) names the
    slot's blocks, trash-padded past its allocation. The pool and the
    state vectors are written in place; no tensor is read back. Returns
    ``state``."""

    @torch.no_grad()
    def __call__(self, state: DecodeState, rows, slot: int, table_row, *,
                 ctx: int, last_tok: int, temperature: float, top_k: int,
                 top_p: float, eos_id: int, budget: int, adapter: int = 0):
        from ..serving import paged_kv as pk

        leaves = list(pk.paged_leaves(state.caches))
        if len(leaves) != len(rows):
            raise ValueError(f"{len(rows)} bundle leaves for a pool of "
                             f"{len(leaves)} paged buffers")
        for leaf, r in zip(leaves, rows):
            pk.paged_adopt(leaf, r, slot, table_row)
        state.pos[slot] = int(ctx)
        state.tok[slot] = int(last_tok)
        state.done[slot] = False
        state.temperature[slot] = float(temperature)
        state.top_k[slot] = int(top_k)
        state.top_p[slot] = float(top_p)
        state.eos[slot] = int(eos_id)
        state.budget[slot] = int(budget)
        state.adapter[slot] = int(adapter)
        return state


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------


def spec_k_default() -> int:
    """``PADDLE_SERVE_SPEC_K``: tokens the draft proposes per speculative
    round (default 4, at least 1)."""
    try:
        return max(int(os.environ.get("PADDLE_SERVE_SPEC_K", "4")), 1)
    except ValueError:
        return 4


class SpecDecodeState:
    """Device-resident state of the speculative loop: the target's caches
    and the draft's, both at the accepted sequence's positions, and the
    per-slot vectors. Greedy only: the accept rule compares argmaxes.

    caches, draft_caches : per-layer caches of the target and the draft
    pos    : [B] int32 — next write position per slot
    tok    : [B] int32 — the last accepted token, fed next round
    done   : [B] bool
    eos    : [B] int32 — stop token per slot (-1 = none)
    budget : [B] int32 — tokens each slot may still emit
    """

    FIELDS = ("caches", "draft_caches", "pos", "tok", "done", "eos",
              "budget")
    __slots__ = FIELDS

    def __init__(self, caches, draft_caches, pos, tok, done, eos, budget):
        self.caches = caches
        self.draft_caches = draft_caches
        self.pos = pos
        self.tok = tok
        self.done = done
        self.eos = eos
        self.budget = budget

    @classmethod
    def make(cls, caches, draft_caches, first_tokens, pos, *, eos_id=None,
             budget=None):
        """A fresh state on the caches' device. Scalars broadcast to [B];
        ``budget`` None is unbounded."""
        dev = _cache_device(caches)
        tok = torch.as_tensor(first_tokens, dtype=torch.int32, device=dev)
        B = int(tok.shape[0])

        def vec(v):
            return torch.as_tensor(v, dtype=torch.int32, device=dev) \
                .expand(B).clone()

        return cls(caches, draft_caches,
                   torch.as_tensor(pos, dtype=torch.int32, device=dev), tok,
                   torch.zeros(B, dtype=torch.bool, device=dev),
                   vec(-1 if eos_id is None else eos_id),
                   vec(NO_BUDGET if budget is None else budget))


class SpeculativeDecodeStep:
    """One greedy speculative round::

        step = SpeculativeDecodeStep(model, draft_model, k=4)
        emitted, state = step(state)   # all on the device

    The draft proposes ``k`` tokens, one single-token forward each at
    ``pos + i``; the target scores ``[tok, d_1 .. d_k]`` in one forward;
    the accept fold runs on the device with no host read: draft ``d_i``
    survives while it and every draft before it equal the target's argmax,
    and the round emits the target's own argmaxes up to and including its
    correction at the first mismatch, capped by the budget and cut after
    the first stop token. So the tokens are those of the plain greedy
    ``DecodeStep``, 1 to k + 1 per round. ``emitted`` is ``[B, k+1]``
    int32 with ``-1`` past each slot's count (and everywhere for a done
    slot).

    A round writes k + 1 rows at ``pos .. pos+k`` of the target's cache
    (rejected rows are overwritten before any query can see them), so the
    caches need ``k`` rows of headroom past the last real token;
    ``generate`` reserves it. As in the JAX package, the draft writes rows
    ``pos .. pos+k-1`` and never feeds ``d_k``: after a round that accepts
    all k drafts its row ``pos + k`` stays stale, which lowers acceptance
    and never changes a token."""

    def __init__(self, model, draft_model, *, k=None):
        self.model = model
        self.draft_model = draft_model
        self.k = int(k) if k is not None else spec_k_default()
        if self.k < 1:
            raise ValueError(
                f"SpeculativeDecodeStep needs k >= 1 draft tokens per round "
                f"(got {self.k})")
        self._n_steps = 0

    @torch.no_grad()
    def __call__(self, state: SpecDecodeState):
        """-> (emitted [B, k+1] int32 with -1 sentinels, the new state)."""
        K = self.k
        pos, tok, done = state.pos, state.tok, state.done
        cur, dc = tok, state.draft_caches
        drafts = []
        for i in range(K):
            dlogits, dc = self.draft_model(cur[:, None], cache=dc,
                                           pos=pos + i)
            cur = dlogits[:, -1, :].float().argmax(-1).to(torch.int32)
            drafts.append(cur)
        drafts = torch.stack(drafts, dim=1)  # [B, K]
        tlogits, caches = self.model(
            torch.cat([tok[:, None], drafts], dim=1), cache=state.caches,
            pos=pos)
        g = tlogits.float().argmax(-1).to(torch.int32)  # [B, K+1]
        match = (drafts == g[:, :K]).to(torch.int32)
        n_acc = torch.cumprod(match, dim=1).sum(dim=1)  # [B] 0..K
        n_emit = torch.minimum(n_acc + 1, state.budget.clamp(min=0))
        n_emit = torch.where(done, 0, n_emit)
        j = torch.arange(K + 1, device=pos.device)
        base = j[None, :] < n_emit[:, None]
        eos_hit = base & (g == state.eos[:, None])
        any_eos = eos_hit.any(dim=1)
        # the first stop token's index: argmax over the int mask (the first
        # maximum wins, as in jnp.argmax)
        first_eos = torch.where(any_eos, eos_hit.to(torch.int32).argmax(1),
                                K + 1)
        emit_mask = base & (j[None, :] <= first_eos[:, None])
        emit = torch.where(emit_mask, g, -1)
        n_final = emit_mask.sum(dim=1).to(pos.dtype)
        new_budget = state.budget - n_final
        new_done = done | any_eos | (new_budget <= 0)
        last = (n_final.to(torch.int64) - 1).clamp(0, K)
        feed = torch.gather(g, 1, last[:, None])[:, 0]
        feed = torch.where(new_done, 0, feed)
        self._n_steps += 1
        return emit, SpecDecodeState(caches, dc, pos + n_final, feed,
                                     new_done, state.eos, new_budget)
