"""Single-token decode step and bucketed prefill (counterpart of
``paddle_tpu/jit/decode_step.py``'s ``DecodeState``, ``DecodeStep`` and
``PrefillStep``).

PyTorch runs them eagerly: where the JAX package compiles one program per
step, each step here is the same sequence of kernel launches. The loop
state (``DecodeState``) lives on the device: tokens, positions, done
flags, budgets and the sampling generator never visit the host between
steps, and nothing in a step reads the device back. Stop conditions fold
into the step: a slot whose token hits its ``eos`` id, or whose budget
runs out, flips ``done`` and emits the sentinel ``-1`` from then on.
"""
from __future__ import annotations

import torch

from ..core.random import generator as make_generator

__all__ = ["NO_BUDGET", "DecodeState", "DecodeStep", "PrefillStep"]

#: effectively unbounded per-slot step budget (the host loop bounds it)
NO_BUDGET = 1 << 30


def _cache_device(caches) -> torch.device:
    """The device of a model's cache list (contiguous or paged)."""
    k = caches[0].k
    return (k.kv if isinstance(k, tuple) else k).device


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
