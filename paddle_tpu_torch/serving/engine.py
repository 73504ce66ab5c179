"""Decode loop and continuous-batching engine (counterpart of
``paddle_tpu/serving/engine.py``, contiguous cache pool).

- :func:`generate` — the whole-batch loop: bucketed prefill, one
  single-token step per token, device-resident loop state. With
  ``sync_every=0`` (the default without a stop token) the host reads the
  device once, after the loop.
- :class:`InferenceEngine` — slot-based continuous batching: a fixed
  ``[slots, H, cap, Dh]`` cache pool, batch-1 prefill into a length
  bucket, insert-on-free (a finished slot refills from the queue at the
  next readback), per-slot sampling parameters, stop ids and budgets on
  the device, and host readbacks only every ``PADDLE_SERVE_SYNC_EVERY``
  steps.

Env knobs, with the JAX package's meanings:
  ``PADDLE_SERVE_SYNC_EVERY``  decode steps per engine readback (16)
  ``PADDLE_SERVE_BUCKETS``     prefill length buckets
                               ("16,32,64,128,256,512,1024")
"""
from __future__ import annotations

import itertools
import os
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.random import generator as make_generator
from ..jit.decode_step import DecodeState, DecodeStep, PrefillStep
from . import sampling

__all__ = ["GenerationConfig", "generate", "Request", "GeneratedResult",
           "InferenceEngine", "prefill_buckets", "bucket_for"]

_SYNC_ENV = "PADDLE_SERVE_SYNC_EVERY"
_BUCKETS_ENV = "PADDLE_SERVE_BUCKETS"


def sync_every_default() -> int:
    try:
        return max(int(os.environ.get(_SYNC_ENV, "16")), 1)
    except ValueError:
        return 16


def prefill_buckets() -> List[int]:
    """The prefill length buckets (sorted); prompts pad up to theirs."""
    raw = os.environ.get(_BUCKETS_ENV, "16,32,64,128,256,512,1024")
    out = sorted({int(t) for t in raw.split(",") if t.strip()})
    if not out:
        raise ValueError(f"{_BUCKETS_ENV} parsed to no buckets: {raw!r}")
    return out


def bucket_for(length: int, cap: int,
               buckets: Optional[List[int]] = None) -> int:
    """Smallest bucket >= length, clamped to the cache capacity; lengths
    past the largest bucket use the capacity itself."""
    if length > cap:
        raise ValueError(f"prompt length {length} exceeds cache "
                         f"capacity {cap}")
    for b in (buckets if buckets is not None else prefill_buckets()):
        if b >= length:
            return min(b, cap)
    return cap


class GenerationConfig:
    """Sampling and stop settings for :func:`generate` (scalars or per-row
    vectors): temperature <= 0 greedy, top_k <= 0 / top_p >= 1 off."""

    def __init__(self, max_new_tokens=16, temperature=0.0, top_k=0,
                 top_p=1.0, eos_id=None, seed=0):
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.eos_id = eos_id
        self.seed = seed


def _pad_prompts(prompts, pad_to, pad_id=0):
    """Ragged int prompts -> (ids [B, pad_to] int32, lengths [B])."""
    rows = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    lens = np.asarray([r.size for r in rows], np.int32)
    ids = np.full((len(rows), pad_to), pad_id, np.int32)
    for i, r in enumerate(rows):
        ids[i, : r.size] = r
    return ids, lens


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=None, *, config=None,
             temperature=0.0, top_k=0, top_p=1.0, eos_id=None, seed=0,
             max_length=None, sync_every=None, return_logits=False,
             prefill=None):
    """Decode ``max_new_tokens`` tokens for a whole batch, on the device
    the model lives on.

    Returns ``[B, max_new_tokens]`` int32 numpy tokens (``-1`` after a row
    hit its stop token); with ``return_logits=True`` also the
    ``[B, N, V]`` f32 per-step logits. ``sync_every=0`` (default when no
    ``eos_id``) never reads the device inside the loop; with a stop token
    the default checks the done mask every ``PADDLE_SERVE_SYNC_EVERY``
    steps to stop early. ``prefill`` takes a prebuilt ``PrefillStep``."""
    cfg = config if config is not None else GenerationConfig(
        temperature=temperature, top_k=top_k, top_p=top_p, eos_id=eos_id,
        seed=seed)
    n_new = int(max_new_tokens) if max_new_tokens is not None \
        else cfg.max_new_tokens
    model.eval()
    rows = [np.asarray(p, np.int32).reshape(-1) for p in input_ids]
    B = len(rows)
    max_len = max(r.size for r in rows)
    cap = int(max_length) if max_length is not None else max_len + n_new
    if max_len + n_new > cap + 1:
        raise ValueError(f"max_length={cap} cannot hold prompt ({max_len}) "
                         f"+ {n_new} new tokens")
    ids, lens = _pad_prompts(rows, bucket_for(max_len, cap))

    pre = prefill if prefill is not None else PrefillStep(model)
    step = DecodeStep(model)
    last, caches, pos = pre(model.gen_cache(B, cap), ids, lens)

    # the first token is sampled here, outside the step; the step budget
    # covers the remaining n_new - 1
    state = DecodeState.make(
        caches, first_tokens=np.zeros(B, np.int32), pos=pos, seed=cfg.seed,
        temperature=cfg.temperature, top_k=cfg.top_k, top_p=cfg.top_p,
        eos_id=cfg.eos_id, budget=n_new - 1)
    first = sampling.sample(last, state.generator, state.temperature,
                            state.top_k, state.top_p)
    state.done = first == state.eos
    state.tok = torch.where(state.done, 0, first)

    emits = [first]
    logits_all = [last] if return_logits else None
    if sync_every is None:
        sync_every = 0 if cfg.eos_id is None else sync_every_default()
    since_sync = 0
    for _ in range(n_new - 1):
        emit, logits, state = step(state)
        emits.append(emit)
        if return_logits:
            logits_all.append(logits)
        since_sync += 1
        if sync_every and since_sync >= sync_every:
            since_sync = 0
            if bool(state.done.all()):
                break
    toks = torch.stack(emits, dim=1).cpu().numpy()
    out = np.full((B, n_new), -1, np.int32)
    out[:, : toks.shape[1]] = toks
    if return_logits:
        return out, torch.stack(logits_all, dim=1).cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

_rid_counter = itertools.count()


class Request:
    """One generation request for the engine."""

    def __init__(self, prompt_ids, max_new_tokens=16, temperature=0.0,
                 top_k=0, top_p=1.0, eos_id=None, rid=None):
        self.prompt_ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_id = -1 if eos_id is None else int(eos_id)
        self.rid = next(_rid_counter) if rid is None else rid
        self.t_submit: Optional[float] = None  # set by engine.submit


class GeneratedResult:
    """A finished request: generated ids and its latencies (host clock,
    ms). ``prefill_ms`` runs from the start of its prefill to its first
    token on the host; ``ttft_ms`` from submit to that token."""

    def __init__(self, rid, tokens, prefill_ms, total_ms, ttft_ms):
        self.rid = rid
        self.tokens = list(tokens)
        self.prefill_ms = prefill_ms
        self.total_ms = total_ms
        self.ttft_ms = ttft_ms


class _Slot:
    __slots__ = ("req", "t_start", "prefill_ms", "tokens", "ttft_ms")

    def __init__(self, req, t_start, prefill_ms, first_token, ttft_ms):
        self.req = req
        self.t_start = t_start
        self.prefill_ms = prefill_ms
        self.tokens = [int(first_token)]
        self.ttft_ms = ttft_ms


class InferenceEngine:
    """Slot-based continuous batching over one model.

    The decode batch is a fixed pool of ``slots``, each holding one
    request. A request prefills at batch 1 into its length bucket; its
    cache is copied into a free slot of the pool and its first token
    sampled (the one host read per request). Decode runs in windows of
    ``sync_every`` steps with one readback each; a slot that finished in
    the window (stop id, budget) is refilled from the queue at the next
    turn."""

    def __init__(self, model, *, slots=4, max_length=256, sync_every=None,
                 seed=0):
        model.eval()
        self.model = model
        self.slots = int(slots)
        self.max_length = int(max_length)
        self.sync_every = (sync_every_default() if sync_every is None
                           else max(int(sync_every), 1))
        self._prefill = PrefillStep(model)
        self._decode = DecodeStep(model)
        self._queue: deque = deque()
        self._active: Dict[int, _Slot] = {}
        self._state = DecodeState.make(
            model.gen_cache(self.slots, self.max_length),
            first_tokens=np.zeros(self.slots, np.int32),
            pos=np.zeros(self.slots, np.int32), seed=seed)
        self._state.done.fill_(True)  # every slot starts free
        self._gen = make_generator(seed, self._state.pos.device)

    # -- public API --------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.prompt_ids.size + req.max_new_tokens > self.max_length:
            raise ValueError(
                f"request {req.rid}: prompt ({req.prompt_ids.size}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds "
                f"max_length={self.max_length}")
        req.t_submit = time.perf_counter()
        self._queue.append(req)

    def run(self) -> Dict[object, GeneratedResult]:
        """Drain the queue; returns rid -> GeneratedResult."""
        results: Dict[object, GeneratedResult] = {}
        while self.turn(results):
            pass
        return results

    @torch.no_grad()
    def turn(self, results: Dict[object, GeneratedResult]) -> bool:
        """One scheduling turn: fill free slots, run one decode window,
        collect its readback. True while work remains."""
        if not (self._queue or self._active):
            return False
        self._fill_free_slots(results)
        if not self._active:
            return bool(self._queue)
        emits = []
        for _ in range(self.sync_every):
            emit, _, self._state = self._decode(self._state)
            emits.append(emit)
        # the readback: one stacked token transfer plus the done mask per
        # window, the only recurring device-to-host reads of the loop
        tok_block = torch.stack(emits, dim=0).cpu().numpy()
        done = self._state.done.cpu().numpy()
        self._collect(tok_block, done, results)
        return bool(self._queue or self._active)

    # -- internals ---------------------------------------------------------
    def _fill_free_slots(self, results) -> None:
        free = [s for s in range(self.slots) if s not in self._active]
        for slot in free:
            if not self._queue:
                break
            req = self._queue.popleft()
            t0 = time.perf_counter()
            L = req.prompt_ids.size
            ids, lens = _pad_prompts([req.prompt_ids],
                                     bucket_for(L, self.max_length))
            last, slot_caches, _ = self._prefill(
                self.model.gen_cache(1, self.max_length), ids, lens)
            first = self._insert(slot, req, slot_caches, last)
            now = time.perf_counter()
            prefill_ms = (now - t0) * 1e3
            ttft_ms = (now - req.t_submit) * 1e3
            if first == req.eos_id or req.max_new_tokens <= 1:
                # degenerate request: done at its first token
                results[req.rid] = GeneratedResult(
                    req.rid, [first], prefill_ms, prefill_ms, ttft_ms)
                self._state.done[slot] = True
            else:
                self._active[slot] = _Slot(req, t0, prefill_ms, first,
                                           ttft_ms)

    def _insert(self, slot, req, slot_caches, last) -> int:
        """Copy a prefilled batch-1 cache into pool slot ``slot``, reset
        that slot's state entries, and return its first token."""
        st = self._state
        dev = st.pos.device
        first = sampling.sample(
            last, self._gen,
            torch.tensor([req.temperature], device=dev),
            torch.tensor([req.top_k], dtype=torch.int32, device=dev),
            torch.tensor([req.top_p], device=dev))
        for pool, one in zip(st.caches, slot_caches):
            pool.k[slot].copy_(one.k[0])
            pool.v[slot].copy_(one.v[0])
        st.pos[slot] = req.prompt_ids.size
        st.tok[slot] = first[0]
        st.done[slot] = False
        st.temperature[slot] = req.temperature
        st.top_k[slot] = req.top_k
        st.top_p[slot] = req.top_p
        st.eos[slot] = req.eos_id
        st.budget[slot] = req.max_new_tokens - 1
        return int(first[0])

    def _collect(self, tok_block, done, results) -> None:
        """Fold one readback window into the requests' host state and
        retire finished slots; a done slot emits the -1 sentinel."""
        finished = []
        for slot, st in self._active.items():
            for t in range(tok_block.shape[0]):
                tok = int(tok_block[t, slot])
                if tok < 0:
                    break
                st.tokens.append(tok)
            if done[slot]:
                finished.append(slot)
        for slot in finished:
            st = self._active.pop(slot)
            results[st.req.rid] = GeneratedResult(
                st.req.rid, st.tokens, st.prefill_ms,
                (time.perf_counter() - st.t_start) * 1e3, st.ttft_ms)
