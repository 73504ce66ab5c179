"""Decode loop and continuous-batching engine (counterpart of
``paddle_tpu/serving/engine.py``).

- :func:`generate` — the whole-batch loop: bucketed prefill, one
  single-token step per token, device-resident loop state. With
  ``sync_every=0`` (the default without a stop token) the host reads the
  device once, after the loop. The cache is paged when
  ``PADDLE_SERVE_BLOCK_SIZE`` is set, int8/fp8 when
  ``PADDLE_SERVE_KV_QUANT`` is. With ``draft_model`` the loop is greedy
  speculative decoding (``jit.SpeculativeDecodeStep``): 1 to ``spec_k`` +
  1 tokens per round, the tokens of the plain greedy loop.
- :class:`InferenceEngine` — slot-based continuous batching: a cache pool
  of ``slots``, batch-1 prefill into a length bucket, insert-on-free (a
  finished slot refills from the queue at the next readback), per-slot
  sampling parameters, stop ids, budgets and adapter ids on the device,
  and host readbacks only every ``PADDLE_SERVE_SYNC_EVERY`` steps.

The engine's serving tier, as in the JAX package:

- **paged KV pool** (``block_size``): the cache is a ``paged_kv`` block
  pool with per-slot tables; a request takes ``ceil((prompt + max_new) /
  bs)`` blocks at insert and frees them at retire, so memory follows the
  requests' lengths, and admission defers while the pool cannot cover the
  next request;
- **chunked prefill** (``prefill_chunk``): a long prompt prefills one
  chunk per engine turn, with decode windows in between, through
  ``PrefillStep``'s ``start`` seam, so one long prompt does not stall
  every request in flight;
- **prefix cache** (``prefix_cache``, paged pools only): published prompt
  blocks are shared by table reference, admission charges only the
  unshared blocks, the borrower prefills only its tail (after the shared
  K/V are copied into its scratch cache), and the splice is the
  copy-on-write ``paged_splice_tail``;
- **adapter fleets**: with a ``serving.adapters.AdapterSet`` attached to
  the model before the engine is built, ``Request(adapter=)`` ids ride
  every insert path and the decode state;
- **quantized KV** (``PADDLE_SERVE_KV_QUANT``): the pool, contiguous or
  paged, holds int8/fp8 payloads and their scales (``QuantKV``), and every
  splice and copy-on-write moves both.

The router's plane, as in the JAX package:

- **KV migration** (``extract_kv`` / ``insert_migrated``, paged pools):
  an active request's blocks leave as a sealed ``kv_migration.KVBundle``
  and splice into another engine's free slot through
  ``jit.MigrateInsert``; decode goes on mid-sentence with no prefill.
  ``Request(resume_tokens=)`` is the other road back: the engine prefills
  prompt plus resumed tokens (``Request.prefill_ids``);
- **elastic slots**: ``expand_slots`` grows the pool (state vectors,
  cache rows, ``BlockPool.grow``); ``retire_slots`` stops refilling the
  top slots, moves their active requests into free low slots through the
  migration plane, and truncates the pool once the tail is free;
- **telemetry** (``observability.metrics.DecodeMetricsSampler``):
  ``decode_metrics`` rows at each readback, ``decode_request`` rows at
  each retire, and span rows for traced requests (``Request(trace_id=)``),
  all from host values the engine already holds: no extra device read.

Env knobs, with the JAX package's meanings:
  ``PADDLE_SERVE_SYNC_EVERY``    decode steps per engine readback (16)
  ``PADDLE_SERVE_BUCKETS``       prefill length buckets
                                 ("16,32,64,128,256,512,1024")
  ``PADDLE_SERVE_BLOCK_SIZE``    KV block size; 0 = contiguous cache
  ``PADDLE_SERVE_PREFILL_CHUNK`` prefill chunk length; 0 = whole prompt
  ``PADDLE_SERVE_PREFIX_CACHE``  1 = refcounted CoW prefix cache (0)
  ``PADDLE_SERVE_PREFIX_BLOCKS`` max prefix-cache entries (0 = the pool)
  ``PADDLE_SERVE_KV_QUANT``      int8 / fp8 KV cache (off)
  ``PADDLE_SERVE_SPEC_K``        draft tokens per speculative round (4)
  ``PADDLE_SERVE_MIGRATE``       1 = move KV on slot retirement (default)
  ``PADDLE_OBS_DECODE_METRICS``  0 = no decode telemetry rows (1)
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
from ..distributed import quantized_comm as qc
from ..jit.decode_step import (NO_BUDGET, DecodeState, DecodeStep,
                               MigrateInsert, PrefillStep, SpecDecodeState,
                               SpeculativeDecodeStep, spec_k_default)
from ..observability import bus
from ..observability.metrics import DecodeMetricsSampler
from . import kv_migration as kvm
from . import paged_kv as pk
from . import sampling
from .prefix_cache import PrefixCache, prefix_cache_enabled

__all__ = ["GenerationConfig", "generate", "Request", "GeneratedResult",
           "InferenceEngine", "prefill_buckets", "bucket_for",
           "prefill_chunk_default"]

_SYNC_ENV = "PADDLE_SERVE_SYNC_EVERY"
_BUCKETS_ENV = "PADDLE_SERVE_BUCKETS"
_CHUNK_ENV = "PADDLE_SERVE_PREFILL_CHUNK"


def sync_every_default() -> int:
    try:
        return max(int(os.environ.get(_SYNC_ENV, "16")), 1)
    except ValueError:
        return 16


def prefill_chunk_default() -> int:
    """``PADDLE_SERVE_PREFILL_CHUNK``: prompt tokens per prefill chunk; 0
    (default) prefills whole prompts."""
    try:
        return max(int(os.environ.get(_CHUNK_ENV, "0")), 0)
    except ValueError:
        return 0


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


def _spec_generate(model, draft_model, rows, n_new, cfg, cap, bucket,
                   sync_every, spec_k, prefill, decode):
    """The speculative greedy loop behind :func:`generate`: each
    ``SpeculativeDecodeStep`` round emits 1..k+1 tokens per slot, and the
    host drops the -1 sentinels after the loop, so its reads follow the
    readback windows as in the plain loop."""
    B = len(rows)
    ids, lens = _pad_prompts(rows, bucket)
    pre = prefill if prefill is not None else PrefillStep(model)
    step = decode if isinstance(decode, SpeculativeDecodeStep) else \
        SpeculativeDecodeStep(model, draft_model, k=spec_k)
    # the draft's prefill is kept on the step object, for the next call
    dpre = getattr(step, "_draft_prefill", None)
    if dpre is None:
        dpre = step._draft_prefill = PrefillStep(draft_model)
    last, caches, pos = pre(model.gen_cache(B, cap), ids, lens)
    _, dcaches, _ = dpre(draft_model.gen_cache(B, cap), ids, lens)
    first = sampling.greedy(last)
    state = SpecDecodeState.make(caches, dcaches, first, pos,
                                 eos_id=cfg.eos_id, budget=n_new - 1)
    state.done = first == state.eos
    state.tok = torch.where(state.done, 0, first)

    emits = [first[:, None]]
    # None: the default cadence (the budget ends the loop on the device,
    # so a done check only saves rounds); an explicit 0 reads the device
    # once, after the loop
    sync = sync_every_default() if sync_every is None \
        else max(int(sync_every), 0)
    since = 0
    # every round emits at least one token per live slot, so n_new - 1
    # rounds always spend the budget
    for _ in range(n_new - 1):
        emit, state = step(state)
        emits.append(emit)
        since += 1
        if sync and since >= sync:
            since = 0
            if bool(state.done.all()):
                break
    seq = torch.cat(emits, dim=1).cpu().numpy()
    out = np.full((B, n_new), -1, np.int32)
    for b in range(B):
        row = [int(t) for t in seq[b] if t >= 0]
        out[b, : min(len(row), n_new)] = row[:n_new]
    return out


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=None, *, config=None,
             temperature=0.0, top_k=0, top_p=1.0, eos_id=None, seed=0,
             max_length=None, sync_every=None, return_logits=False,
             prefill=None, decode=None, draft_model=None, spec_k=None):
    """Decode ``max_new_tokens`` tokens for a whole batch, on the device
    the model lives on.

    Returns ``[B, max_new_tokens]`` int32 numpy tokens (``-1`` after a row
    hit its stop token); with ``return_logits=True`` also the
    ``[B, N, V]`` f32 per-step logits. ``sync_every=0`` (default when no
    ``eos_id``) never reads the device inside the loop; with a stop token
    the default checks the done mask every ``PADDLE_SERVE_SYNC_EVERY``
    steps to stop early. ``prefill``/``decode`` take prebuilt
    ``PrefillStep``/``DecodeStep`` objects. The cache comes from
    ``model.gen_cache(B, cap)``: paged under ``PADDLE_SERVE_BLOCK_SIZE``,
    int8/fp8 under ``PADDLE_SERVE_KV_QUANT``.

    ``draft_model`` switches to greedy speculative decoding: ``spec_k``
    drafts per round (default ``PADDLE_SERVE_SPEC_K``, or the k of a
    prebuilt ``SpeculativeDecodeStep`` passed as ``decode``, which a
    different ``spec_k`` contradicts), the same tokens as the plain greedy
    loop. Sampling and ``return_logits`` raise. The cache holds ``spec_k``
    rows of headroom for a round's rejected writes; the done check runs
    every ``PADDLE_SERVE_SYNC_EVERY`` rounds unless ``sync_every`` says
    otherwise."""
    cfg = config if config is not None else GenerationConfig(
        temperature=temperature, top_k=top_k, top_p=top_p, eos_id=eos_id,
        seed=seed)
    n_new = int(max_new_tokens) if max_new_tokens is not None \
        else cfg.max_new_tokens
    model.eval()
    rows = [np.asarray(p, np.int32).reshape(-1) for p in input_ids]
    B = len(rows)
    max_len = max(r.size for r in rows)
    if draft_model is not None:
        if np.any(np.asarray(cfg.temperature, np.float32) > 0.0):
            raise ValueError(
                "speculative decoding is greedy-only (the accept rule "
                "compares argmaxes); pass temperature<=0 or drop "
                "draft_model")
        if return_logits:
            raise ValueError(
                "return_logits is not supported with draft_model: the "
                "speculative step folds the target's logits into the accept "
                "decision on the device")
        draft_model.eval()
        if isinstance(decode, SpeculativeDecodeStep):
            # the prebuilt step's k sets how many rows a round writes, so
            # it sets the headroom
            if spec_k is not None and int(spec_k) != decode.k:
                raise ValueError(
                    f"spec_k={spec_k} conflicts with the prebuilt decode "
                    f"step's k={decode.k}")
            K = decode.k
        else:
            K = int(spec_k) if spec_k is not None else spec_k_default()
        # a round writes k + 1 rows at pos .. pos+k: the rejected tail must
        # land inside the cache, or a clamped write would move onto live
        # rows
        cap = int(max_length) if max_length is not None \
            else max_len + n_new + K
        if max_len + n_new + K > cap:
            raise ValueError(
                f"max_length={cap} cannot hold prompt ({max_len}) + "
                f"{n_new} new tokens + spec_k={K} headroom")
        return _spec_generate(model, draft_model, rows, n_new, cfg, cap,
                              bucket_for(max_len, cap), sync_every, K,
                              prefill, decode)
    cap = int(max_length) if max_length is not None else max_len + n_new
    if max_len + n_new > cap + 1:
        raise ValueError(f"max_length={cap} cannot hold prompt ({max_len}) "
                         f"+ {n_new} new tokens")
    ids, lens = _pad_prompts(rows, bucket_for(max_len, cap))

    pre = prefill if prefill is not None else PrefillStep(model)
    step = decode if decode is not None else DecodeStep(model)
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
    """One generation request for the engine. ``adapter`` names the
    fine-tune that serves it, a row of the model's ``AdapterSet``; 0
    (default) is the base model.

    ``resume_tokens`` carries tokens an earlier host already emitted for
    this request (the router's failover and drain): the engine prefills
    ``prompt_ids + resume_tokens`` as one prefix, the caller has already
    taken them off ``max_new_tokens``, and a greedy request goes on token
    for token where the earlier host stopped. The result holds only the
    new tokens. ``trace_id`` (stamped by the router) keys the request's
    span rows; None leaves them out."""

    def __init__(self, prompt_ids, max_new_tokens=16, temperature=0.0,
                 top_k=0, top_p=1.0, eos_id=None, rid=None, trace_id=None,
                 resume_tokens=None, adapter=0):
        self.prompt_ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        self.resume_tokens = (
            np.asarray([], np.int32) if resume_tokens is None
            else np.asarray(resume_tokens, np.int32).reshape(-1))
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_id = -1 if eos_id is None else int(eos_id)
        self.adapter = int(adapter)
        self.rid = next(_rid_counter) if rid is None else rid
        self.trace_id = trace_id
        self.t_submit: Optional[float] = None  # set by engine.submit

    @property
    def prefill_ids(self) -> np.ndarray:
        """The tokens the engine prefills: the prompt and any resumed
        tokens."""
        if self.resume_tokens.size == 0:
            return self.prompt_ids
        return np.concatenate([self.prompt_ids, self.resume_tokens])


class GeneratedResult:
    """A finished request: generated ids and its latencies (host clock,
    ms). ``prefill_ms`` runs from the start of its prefill to its first
    token on the host; ``ttft_ms`` from submit to that token (queue wait
    and chunked prefill included)."""

    def __init__(self, rid, tokens, prefill_ms, total_ms, ttft_ms=None):
        self.rid = rid
        self.tokens = list(tokens)
        self.prefill_ms = prefill_ms
        self.total_ms = total_ms
        self.ttft_ms = prefill_ms if ttft_ms is None else ttft_ms

    @property
    def ms_per_token(self):
        return self.total_ms / max(len(self.tokens), 1)


class _Slot:
    __slots__ = ("req", "t_start", "prefill_ms", "tokens", "ttft_ms")

    def __init__(self, req, t_start, prefill_ms, first_token, ttft_ms):
        self.req = req
        self.t_start = t_start
        self.prefill_ms = prefill_ms
        self.tokens = [int(first_token)]
        self.ttft_ms = ttft_ms


class _Pending:
    """A chunked prefill in flight: its slot and (paged) blocks are held,
    and its batch-1 cache fills one chunk per engine turn."""

    __slots__ = ("req", "slot", "blocks", "caches", "consumed", "t0",
                 "prefill_s")

    def __init__(self, req, slot, blocks, caches, t0):
        self.req = req
        self.slot = slot
        self.blocks = blocks
        self.caches = caches
        self.consumed = 0
        self.t0 = t0
        self.prefill_s = 0.0


def _map_buffers(caches, paged, dense):
    """A cache list with each layer's K and V buffer mapped: ``paged`` for
    a ``PagedKV``, ``dense`` for a contiguous tensor or ``QuantKV``."""
    return [type(c)(*(paged(b) if isinstance(b, pk.PagedKV) else dense(b)
                      for b in c)) for c in caches]


def _on_rows(buf, fn):
    """``fn`` on each tensor of a buffer (a ``QuantKV``'s payload and
    scales alike), through its bytes for float8."""
    out = [qc.from_bits(fn(qc.bits(t)), t.dtype) for t in qc.tensors_of(buf)]
    return qc.QuantKV(*out) if isinstance(buf, qc.QuantKV) else out[0]


def _pad_rows(t, n, fill=0):
    """``t`` with ``n`` rows of ``fill`` appended along dim 0."""
    return torch.cat([t, torch.full((n,) + tuple(t.shape[1:]), fill,
                                    dtype=t.dtype, device=t.device)])


class InferenceEngine:
    """Slot-based continuous batching over one model.

    The decode batch is a fixed pool of ``slots``, each holding one
    request. A request prefills at batch 1 (whole, into its length bucket,
    or in ``prefill_chunk`` pieces); its cache is copied into its slot of
    the pool and its first token sampled (the one host read per request).
    Decode runs in windows of ``sync_every`` steps with one readback each;
    a slot that finished in the window (stop id, budget) is refilled from
    the queue at the next turn.

    With ``block_size`` (or the env default) the pool is paged:
    ``pool_blocks`` blocks (default ``slots * ceil(max_length / bs) + 1``,
    the trash block included), each request taking its blocks for its
    life; when the pool cannot cover the request at the head of the queue,
    admission defers (head of line: skipping ahead would starve long
    requests), and a request no pool could cover raises at submit.
    Retired slots' table rows are redirected to the trash block before
    their blocks can be reallocated. ``prefix_cache`` (or the env default)
    shares published prompt blocks between requests. A paged engine also
    hands a live request's KV out (:meth:`extract_kv`) and takes one in
    (:meth:`insert_migrated`); any engine grows and shrinks its slot count
    (:meth:`expand_slots`, :meth:`retire_slots`)."""

    def __init__(self, model, *, slots=4, max_length=256, sync_every=None,
                 seed=0, block_size=None, pool_blocks=None,
                 prefill_chunk=None, prefix_cache=None):
        model.eval()
        self.model = model
        self.slots = int(slots)
        self.max_length = int(max_length)
        self.sync_every = (sync_every_default() if sync_every is None
                           else max(int(sync_every), 1))
        self.block_size = (int(block_size) if block_size is not None
                           else pk.block_size_default())
        self.prefill_chunk = (int(prefill_chunk) if prefill_chunk is not None
                              else prefill_chunk_default())
        self._prefill = PrefillStep(model)
        self._decode = DecodeStep(model)
        self._migrate = MigrateInsert()
        #: the model's resident fine-tune fleet, if it carries one
        self.adapters = getattr(model, "_serve_adapters", None)
        self._prefix_hits = 0
        self._prefix_blocks_shared = 0
        self._cow_copies = 0
        self._queue: deque = deque()
        self._active: Dict[int, _Slot] = {}
        self._pending: Dict[int, _Pending] = {}
        self._pool: Optional[pk.BlockPool] = None
        self._slot_blocks: Dict[int, List[int]] = {}
        self._retiring: set = set()
        self._nmax = 0
        self._admit_deferred = 0
        self._ttft_window: List[float] = []
        if self.prefill_chunk > 0 and self.max_length % self.prefill_chunk:
            # every chunk writes a full chunk-wide window: with cap % C != 0
            # the last chunk of a near-capacity prompt would overrun the
            # cache, whose clamped write would overwrite earlier rows
            raise ValueError(
                f"max_length={self.max_length} must be a multiple of "
                f"prefill_chunk={self.prefill_chunk} (the final chunk "
                f"writes a full chunk-wide window)")
        if self.block_size > 0:
            if self.max_length % self.block_size:
                raise ValueError(
                    f"max_length={self.max_length} must be a multiple of "
                    f"block_size={self.block_size} (the batch-1 prefill "
                    f"cache splices block-aligned)")
            self._nmax = pk.num_blocks(self.max_length, self.block_size)
            total = (pool_blocks if pool_blocks is not None
                     else self.slots * self._nmax + 1)
            self._pool = pk.BlockPool(total)
            caches = model.gen_cache(self.slots, self.max_length,
                                     block_size=self.block_size,
                                     pool_blocks=total)
        else:
            caches = model.gen_cache(self.slots, self.max_length,
                                     block_size=0)
        use_px = (prefix_cache if prefix_cache is not None
                  else prefix_cache_enabled())
        # the share unit is a block: the index needs the paged pool
        self._prefix: Optional[PrefixCache] = (
            PrefixCache(self.block_size)
            if use_px and self._pool is not None else None)
        self._state = DecodeState.make(
            caches, first_tokens=np.zeros(self.slots, np.int32),
            pos=np.zeros(self.slots, np.int32), seed=seed)
        self._state.done.fill_(True)  # every slot starts free
        self._gen = make_generator(seed, self._state.pos.device)
        self._metrics = DecodeMetricsSampler()

    # -- public API --------------------------------------------------------
    def needed_blocks(self, req: Request) -> int:
        """Blocks the paged pool charges ``req`` (0 when contiguous)."""
        if self._pool is None:
            return 0
        return pk.blocks_for(req.prefill_ids.size + req.max_new_tokens,
                             self.block_size)

    def free_blocks(self) -> Optional[int]:
        return None if self._pool is None else self._pool.free

    def queue_depth(self) -> int:
        return len(self._queue)

    def inflight(self) -> int:
        return len(self._active) + len(self._pending)

    def progress(self) -> Dict[object, List[int]]:
        """rid -> tokens emitted so far, for every request the engine
        holds: host state only (active slots report the tokens read back
        at window boundaries, pending and queued requests ``[]``)."""
        out: Dict[object, List[int]] = {}
        for st in self._active.values():
            out[st.req.rid] = list(st.tokens)
        for job in self._pending.values():
            out[job.req.rid] = []
        for req in self._queue:
            out[req.rid] = []
        return out

    def cancel(self, rid) -> bool:
        """Withdraw one request without a result. Queued: dropped. Pending
        prefill or active slot: the slot is marked done and its blocks
        come back. Returns whether anything was withdrawn."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[i]
                return True
        for slot, job in list(self._pending.items()):
            if job.req.rid == rid:
                del self._pending[slot]
                self._release(slot, job.blocks)
                return True
        for slot, st in list(self._active.items()):
            if st.req.rid == rid:
                self._active.pop(slot)
                self._state.done[slot] = True
                self._metrics.span(
                    "cancel", trace_id=st.req.trace_id, rid=rid,
                    slot=slot, tokens=len(st.tokens))
                self._release(slot, self._slot_blocks.pop(slot, None))
                return True
        return False

    # -- elastic slots -----------------------------------------------------
    def expand_slots(self, n: int) -> int:
        """Grow the decode pool by ``n`` slots at a turn boundary: every
        cache buffer gains ``n`` batch rows (paged: ``n * nmax`` fresh pool
        blocks, registered with the ``BlockPool`` at once, and ``n``
        all-trash table rows), and the state vectors gain free (done)
        entries. The new slots fill from the queue at the next turn.
        Emits an ``engine_expand`` bus row. Returns the new slot count."""
        n = int(n)
        if n <= 0:
            return self.slots
        t0 = time.perf_counter()
        old = self.slots
        st = self._state
        if self._pool is not None:
            extra = n * self._nmax
            self._pool.grow(extra)
            caches = _map_buffers(
                st.caches,
                lambda b: pk.PagedKV(
                    _on_rows(b.kv, lambda t: _pad_rows(t, extra)),
                    _pad_rows(b.table, n)),
                lambda b: _on_rows(b, lambda t: _pad_rows(t, n)))
        else:
            caches = _map_buffers(
                st.caches, None,
                lambda b: _on_rows(b, lambda t: _pad_rows(t, n)))
        self.slots = old + n
        self._state = DecodeState(
            caches, _pad_rows(st.pos, n), _pad_rows(st.tok, n),
            _pad_rows(st.done, n, True), st.generator,
            _pad_rows(st.temperature, n), _pad_rows(st.top_k, n),
            _pad_rows(st.top_p, n, 1), _pad_rows(st.eos, n, -1),
            _pad_rows(st.budget, n, NO_BUDGET), _pad_rows(st.adapter, n))
        # what a lent device receives for the wider batch: static shapes
        w_bytes = sum(int(t.numel()) * int(t.element_size())
                      for t in list(self.model.parameters())
                      + list(self.model.buffers()))
        w_quant = sum(1 for name, _ in self.model.named_buffers()
                      if name.endswith("weight_q_scale"))
        bus.emit("engine_expand", {
            "slots_before": old, "slots_after": self.slots,
            "blocks_total": (None if self._pool is None
                             else self._pool.total),
            "weights_bytes": w_bytes, "weights_quantized": w_quant,
            "dur_ms": round((time.perf_counter() - t0) * 1e3, 3)})
        return self.slots

    def retire_slots(self, n: int) -> List[int]:
        """Mark the top ``n`` slots retiring: a retiring slot is never
        refilled, and nothing is cancelled. Its active request moves to a
        free low slot through the migration plane where it can (extract,
        splice, release: :meth:`_relocate_retiring`), else finishes in
        place. Once the retiring tail is free (and, paged, the highest
        block ids are free) the cache buffers, state vectors and
        ``BlockPool`` shrink, checked at every turn. Returns the slots
        still retiring."""
        n = min(int(n), self.slots - 1)
        if n > 0:
            self._retiring.update(range(self.slots - n, self.slots))
            self._relocate_retiring()
            self._maybe_shrink()
        return sorted(self._retiring)

    def _maybe_shrink(self) -> None:
        cut = 0
        while True:
            top = self.slots - 1 - cut
            if (top not in self._retiring or top in self._active
                    or top in self._pending):
                break
            cut += 1
        if cut == 0:
            return
        t0 = time.perf_counter()
        for s in range(self.slots - cut, self.slots):
            self._retiring.discard(s)
        old = self.slots
        new = old - cut
        st = self._state
        if self._pool is not None:
            # live low slots never reference the withdrawn ids: the pool
            # gives up only free top-of-id-space blocks, and retired slots'
            # table rows went to trash at release
            if self._prefix is not None:
                # idle index entries pinning top ids would stall the
                # withdrawal: evict them first
                self._prefix.evict_above(
                    self._pool, self._pool.total - cut * self._nmax)
            self._pool.shrink(cut * self._nmax)
            P = self._pool.total + 1
            caches = _map_buffers(
                st.caches,
                lambda b: pk.PagedKV(
                    _on_rows(b.kv, lambda t: t[:P].clone()),
                    b.table[:new].clone()),
                None)
        else:
            caches = _map_buffers(
                st.caches, None,
                lambda b: _on_rows(b, lambda t: t[:new].clone()))
        self.slots = new
        self._state = DecodeState(
            caches, *(getattr(st, f)[:new].clone() for f in
                      ("pos", "tok", "done")), st.generator,
            *(getattr(st, f)[:new].clone() for f in
              ("temperature", "top_k", "top_p", "eos", "budget",
               "adapter")))
        bus.emit("engine_shrink", {
            "slots_before": old, "slots_after": new,
            "blocks_total": (None if self._pool is None
                             else self._pool.total),
            "dur_ms": round((time.perf_counter() - t0) * 1e3, 3)})

    # -- KV migration ------------------------------------------------------
    def _quant_name(self) -> Optional[str]:
        """The pool's quant policy ("int8" / "fp8", None = raw): bundles
        match by name, the narrow form never converts."""
        for leaf in pk.paged_leaves(self._state.caches):
            if isinstance(leaf.kv, qc.QuantKV):
                return "int8" if leaf.kv.q.dtype == torch.int8 else "fp8"
        return None

    def extract_kv(self, rid):
        """An active request's live KV as a sealed ``KVBundle`` (paged
        pools only; None = nothing to move here, and the caller
        re-prefills). Host state gives the cache position, feed token and
        remaining budget (``ctx = len(prefill) + len(tokens) - 1``, the
        decode step's feed contract), so no state vector is read: only one
        gather per pool tensor. The source keeps serving until the caller
        cancels: extraction is a copy."""
        if self._pool is None:
            return None
        for slot, st in self._active.items():
            if st.req.rid == rid:
                break
        else:
            return None
        req, k = st.req, len(st.tokens)
        budget_left = int(req.max_new_tokens) - k
        blocks = self._slot_blocks.get(slot)
        if not blocks or k < 1 or budget_left < 1:
            return None  # nothing left worth moving: finish in place
        ctx = int(req.prefill_ids.size) + k - 1
        n_used = pk.blocks_for(ctx, self.block_size)
        leaves = kvm.gather_leaves(self._state.caches, blocks[:n_used])
        bundle = kvm.KVBundle({
            "rid": req.rid, "trace_id": req.trace_id,
            "prompt_ids": [int(t) for t in req.prompt_ids],
            "resume": [int(t) for t in req.resume_tokens],
            "emitted": [int(t) for t in st.tokens],
            "ctx": ctx, "last_tok": int(st.tokens[-1]),
            "temperature": req.temperature, "top_k": req.top_k,
            "top_p": req.top_p, "eos_id": req.eos_id,
            "budget_left": budget_left,
            "block_size": self.block_size, "n_blocks": n_used,
            "quant": self._quant_name(),
            "adapter": int(req.adapter),
        }, leaves).seal()
        self._metrics.span(
            "kv_extract", trace_id=req.trace_id, rid=rid, slot=slot,
            blocks=n_used, bytes=bundle.nbytes)
        return bundle

    def insert_migrated(self, req: Request, bundle) -> bool:
        """Splice a migrated bundle into a free slot and resume it
        mid-decode. False = this engine cannot host it (contiguous pool,
        block size, quant policy, adapter, leaf count, no free slot, or a
        pool that cannot cover ``ctx + budget_left``), and the caller
        re-prefills; True = the request decodes its next token here with
        no prefill. The slot's blocks cover its whole remaining life, as a
        prefilled insert's do."""
        if self._pool is None:
            return False
        man = bundle.manifest
        ctx = int(man.get("ctx", 0))
        budget_left = int(man.get("budget_left", 0))
        if (int(man.get("block_size", -1)) != self.block_size
                or man.get("quant") != self._quant_name()
                or budget_left < 1
                or ctx + budget_left > self.max_length):
            return False
        aid = int(man.get("adapter", 0))
        if aid and (self.adapters is None
                    or not self.adapters.is_loaded(aid)):
            return False  # this engine cannot serve the fine-tune
        if len(bundle.leaves) != \
                len(list(pk.paged_leaves(self._state.caches))):
            return False
        free = [s for s in range(self.slots)
                if s not in self._active and s not in self._pending
                and s not in self._retiring]
        if not free:
            return False
        blocks = self._pool.alloc(
            pk.blocks_for(ctx + budget_left, self.block_size))
        if blocks is None:
            return False
        slot = free[0]
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        self._splice_bundle(slot, bundle, blocks)
        sl = _Slot(req, time.perf_counter(), 0.0, 0, ttft_ms=0.0)
        sl.tokens = []  # the result holds the tokens emitted here only
        self._active[slot] = sl
        self._slot_blocks[slot] = blocks
        self._metrics.span(
            "kv_insert", trace_id=req.trace_id, rid=req.rid, slot=slot,
            blocks=bundle.n_blocks, bytes=bundle.nbytes, ctx=ctx)
        return True

    def _splice_bundle(self, slot, bundle, blocks) -> None:
        """Zero-pad the bundle's rows to the table width and splice them,
        with the slot's state reset, through ``jit.MigrateInsert``."""
        man = bundle.manifest
        rows = []
        for leaf in bundle.leaves:
            padded = []
            for t in leaf:
                full = qc.from_bits(torch.zeros(
                    (self._nmax,) + tuple(t.shape[1:]),
                    dtype=qc.bits(t).dtype), t.dtype)
                qc.bits(full)[: t.shape[0]] = qc.bits(t)
                padded.append(full)
            rows.append(tuple(padded))
        row = np.zeros(self._nmax, np.int64)
        row[: len(blocks)] = blocks  # trash-padded past the allocation
        self._migrate(
            self._state, rows, slot, row, ctx=int(man["ctx"]),
            last_tok=int(man["last_tok"]),
            temperature=float(man["temperature"]), top_k=int(man["top_k"]),
            top_p=float(man["top_p"]), eos_id=int(man["eos_id"]),
            budget=int(man["budget_left"]),
            adapter=int(man.get("adapter", 0)))

    def _relocate_retiring(self) -> None:
        """Move active requests off retiring top slots into free low slots
        through the migration plane (extract, splice low, release high) at
        a turn boundary, so ``retire_slots`` need not wait for them to
        finish. The pool charges both allocations for a moment, so a pool
        too full for that tries again next turn. Nothing is cancelled."""
        if self._pool is None or not self._retiring:
            return
        if not kvm.migrate_enabled():
            return
        for slot in sorted(self._retiring, reverse=True):
            st = self._active.get(slot)
            if st is None:
                continue  # free or pending prefill: shrink or chunks
            free = [s for s in range(self.slots)
                    if s < slot and s not in self._active
                    and s not in self._pending
                    and s not in self._retiring]
            if not free:
                continue
            bundle = self.extract_kv(st.req.rid)
            if bundle is None:
                continue  # e.g. one token from done: finish in place
            blocks = self._pool.alloc(pk.blocks_for(
                int(bundle.manifest["ctx"])
                + int(bundle.manifest["budget_left"]),
                self.block_size))
            if blocks is None:
                continue
            tgt = free[0]
            self._splice_bundle(tgt, bundle, blocks)
            self._active.pop(slot)
            self._state.done[slot] = True
            self._release(slot, self._slot_blocks.pop(slot, None))
            moved = _Slot(st.req, st.t_start, st.prefill_ms, 0, st.ttft_ms)
            moved.tokens = list(st.tokens)  # same life, new slot
            self._active[tgt] = moved
            self._slot_blocks[tgt] = blocks
            self._metrics.span(
                "kv_relocate", trace_id=st.req.trace_id,
                rid=st.req.rid, from_slot=slot, to_slot=tgt,
                blocks=bundle.n_blocks, bytes=bundle.nbytes)

    def poison_prefix(self, k: Optional[int] = None) -> bool:
        """Corrupt the ``k``-th oldest prefix-cache entry's key (the
        ``serve:prefix_stale`` fault, forwarded by the router): the next
        lookup misses it and pays a full prefill. False without a prefix
        cache."""
        return (False if self._prefix is None
                else self._prefix.poison(k))

    # -- the queue ---------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.prefill_ids.size + req.max_new_tokens > self.max_length:
            raise ValueError(
                f"request {req.rid}: prompt+resume "
                f"({req.prefill_ids.size}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds "
                f"max_length={self.max_length}")
        if self._pool is not None and \
                self.needed_blocks(req) > self._pool.total:
            raise ValueError(
                f"request {req.rid} needs {self.needed_blocks(req)} KV "
                f"blocks but the pool only has {self._pool.total}: it can "
                f"never be admitted")
        if req.adapter and (self.adapters is None
                            or not self.adapters.is_loaded(req.adapter)):
            raise ValueError(
                f"request {req.rid} names adapter {req.adapter} but "
                + ("no AdapterSet is attached to this engine's model"
                   if self.adapters is None else
                   f"only {self.adapters.resident} are resident"))
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
        """One scheduling turn: advance pending prefills by a chunk, fill
        free slots, run one decode window, collect its readback, move
        requests off retiring slots, and write the window's telemetry.
        True while work remains."""
        if not (self._queue or self._active or self._pending):
            return False
        self._advance_prefills(results)
        progress = self._fill_free_slots(results)
        if not self._active:
            if not self._pending and not progress and self._queue:
                # nothing in flight can free blocks for the head request
                req = self._queue[0]
                raise RuntimeError(
                    f"request {req.rid} cannot be admitted: needs "
                    f"{self.needed_blocks(req)} blocks, "
                    f"{self.free_blocks()} free, nothing in flight to free "
                    f"more")
            return bool(self._queue or self._pending)
        window = self.sync_every
        t0 = time.perf_counter()
        emits = []
        for _ in range(window):
            emit, _, self._state = self._decode(self._state)
            emits.append(emit)
        # the readback: one stacked token transfer plus the done mask per
        # window, the only recurring device-to-host reads of the loop; the
        # telemetry below rides on these host values
        tok_block = torch.stack(emits, dim=0).cpu().numpy()
        done = self._state.done.cpu().numpy()
        dt = time.perf_counter() - t0
        self._metrics.window_span(
            [s.req.trace_id for s in self._active.values()], steps=window)
        self._collect(tok_block, done, results)
        if self._retiring:
            self._relocate_retiring()
            self._maybe_shrink()
        ttfts, self._ttft_window = self._ttft_window, []
        pool, px = self._pool, self._prefix
        self._metrics.window(
            steps=window, tokens=int((tok_block >= 0).sum()), wall_s=dt,
            inflight=len(self._active), queue_depth=len(self._queue),
            ttft_ms=ttfts,
            blocks_in_use=None if pool is None else pool.in_use,
            blocks_total=None if pool is None else pool.total,
            blocks_freed=None if pool is None else pool.freed_total,
            admit_deferred=self._admit_deferred,
            prefix_hits=None if px is None else self._prefix_hits,
            prefix_blocks_shared=(None if px is None
                                  else self._prefix_blocks_shared),
            cow_copies=None if px is None else self._cow_copies,
            adapters_resident=(None if self.adapters is None
                               else len(self.adapters.resident)))
        return bool(self._queue or self._active or self._pending)

    # -- internals ---------------------------------------------------------
    def _slot_cache(self):
        """A contiguous batch-1 cache for one request's prefill (the pool
        may be paged: the splice re-blocks it)."""
        return self.model.gen_cache(1, self.max_length, block_size=0)

    def _row(self, blocks) -> torch.Tensor:
        """A slot's table row: ``blocks``, trash-padded to the width."""
        row = np.zeros(self._nmax, np.int64)
        row[: len(blocks)] = blocks
        return torch.as_tensor(row, device=self._state.pos.device)

    def _advance_prefills(self, results) -> None:
        """One chunk per pending prefill per turn."""
        C = self.prefill_chunk
        for slot in list(self._pending):
            job = self._pending[slot]
            p = job.req.prefill_ids
            t0 = time.perf_counter()
            take = min(C, p.size - job.consumed)
            chunk = np.zeros((1, C), np.int32)
            chunk[0, :take] = p[job.consumed: job.consumed + take]
            last, job.caches, _ = self._prefill(
                job.caches, chunk, [take], start=[job.consumed],
                adapter=[job.req.adapter])
            job.consumed += take
            job.prefill_s += time.perf_counter() - t0
            self._metrics.span(
                "prefill_chunk", trace_id=job.req.trace_id,
                rid=job.req.rid, slot=slot, consumed=job.consumed,
                prompt_len=int(p.size),
                chunk_ms=round((time.perf_counter() - t0) * 1e3, 3))
            if job.consumed >= p.size:
                del self._pending[slot]
                self._activate(slot, job.req, job.caches, last,
                               blocks=job.blocks, t_enq=job.t0,
                               prefill_ms=job.prefill_s * 1e3,
                               results=results)

    def _fill_free_slots(self, results) -> bool:
        if not self._queue:
            return False
        progress = False
        free = [s for s in range(self.slots)
                if s not in self._active and s not in self._pending
                and s not in self._retiring]
        for slot in free:
            if not self._queue:
                break
            req = self._queue[0]
            blocks = share = None
            if self._pool is not None:
                # a matched prefix is taken by table reference, so only
                # the unshared blocks are charged; when even those do not
                # fit, idle cached entries are evicted before deferring
                if self._prefix is not None:
                    share = self._prefix.lookup(req.prefill_ids)
                need = self.needed_blocks(req) - (
                    0 if share is None else len(share.ref_blocks))
                blocks = self._pool.alloc(need)
                if blocks is None and self._prefix is not None:
                    self._prefix.evict_for(self._pool, need)
                    blocks = self._pool.alloc(need)
                if blocks is None:
                    # defer: blocks come back when work in flight retires
                    self._admit_deferred += 1
                    break
            self._queue.popleft()
            progress = True
            self._metrics.span(
                "admit", trace_id=req.trace_id, rid=req.rid, slot=slot,
                queue_wait_ms=(
                    round((time.perf_counter() - req.t_submit) * 1e3, 3)
                    if req.t_submit is not None else None))
            if share is not None:
                self._admit_shared(slot, req, share, blocks, results)
                continue
            L = req.prefill_ids.size
            if 0 < self.prefill_chunk < L:
                self._pending[slot] = _Pending(
                    req, slot, blocks, self._slot_cache(),
                    time.perf_counter())
                continue
            t0 = time.perf_counter()
            ids, lens = _pad_prompts([req.prefill_ids],
                                     bucket_for(L, self.max_length))
            last, slot_caches, _ = self._prefill(
                self._slot_cache(), ids, lens, adapter=[req.adapter])
            self._activate(slot, req, slot_caches, last, blocks=blocks,
                           t_enq=t0,
                           prefill_ms=(time.perf_counter() - t0) * 1e3,
                           results=results)
        return progress

    def _activate(self, slot, req, slot_caches, last, *, blocks, t_enq,
                  prefill_ms, results) -> None:
        """Sample the first token, splice the prefilled cache into the
        pool, publish the prompt's blocks, and park the request in its
        slot or (eos at once, a 1-token budget) finish it."""
        first = self._sample_first(req, last)
        st = self._state
        if self._pool is None:
            for pool, one in zip(st.caches, slot_caches):
                for dst, src in ((pool.k, one.k), (pool.v, one.v)):
                    # a QuantKV copies payload and scales alike
                    for d, s in zip(qc.tensors_of(dst), qc.tensors_of(src)):
                        qc.bits(d)[slot].copy_(qc.bits(s)[0])
        else:
            row = self._row(blocks)
            for pool, one in zip(st.caches, slot_caches):
                pk.paged_splice(pool.k, one.k, slot, row)
                pk.paged_splice(pool.v, one.v, slot, row)
        self._reset_slot(slot, req, first)
        if self._prefix is not None:
            # the index's own references keep the blocks resident for the
            # next borrower even if the request finishes at once
            self._prefix.publish(self._pool, req.prefill_ids, blocks)
        self._park_or_finish(slot, req, int(first[0]), blocks, t_enq,
                             prefill_ms, results)

    def _admit_shared(self, slot, req, share, fresh, results) -> None:
        """Admit a request over a prefix-cache hit: take the matched blocks
        by table reference, copy them into the batch-1 scratch (the tail's
        attention needs the real prefix K/V), prefill only the unshared
        tail in one shot, and splice with ``paged_splice_tail``, which
        first copies the one colliding shared block on a full match."""
        t0 = time.perf_counter()
        self._pool.ref(share.ref_blocks)
        cow = share.cow_src is not None
        table = list(share.ref_blocks) + list(fresh)
        cow_src = share.cow_src if cow else 0
        cow_dst = fresh[0] if cow else 0  # 0, 0: trash onto itself
        # the fetch reads the source chain: on a full match the slot's
        # table row points its last shared block at the private cow_dst,
        # which holds garbage until the splice
        src = self._row(share.src_blocks)
        scratch = self._slot_cache()
        for pool, one in zip(self._state.caches, scratch):
            pk.paged_fetch(pool.k, one.k, src)
            pk.paged_fetch(pool.v, one.v, src)
        ids_all = req.prefill_ids
        L = ids_all.size
        start = int(share.tail_start)
        n_tail = L - start
        # the tail window writes start .. start+W-1 and must stay inside
        # the cache: a bucket against the remaining capacity fits
        W = bucket_for(n_tail, self.max_length - start)
        ids = np.zeros((1, W), np.int32)
        ids[0, :n_tail] = ids_all[start:]
        last, scratch, _ = self._prefill(scratch, ids, [n_tail],
                                         start=[start],
                                         adapter=[req.adapter])
        first = self._sample_first(req, last)
        row = self._row(table)
        for pool, one in zip(self._state.caches, scratch):
            pk.paged_splice_tail(pool.k, one.k, slot, row, start, L,
                                 cow_src, cow_dst)
            pk.paged_splice_tail(pool.v, one.v, slot, row, start, L,
                                 cow_src, cow_dst)
        self._reset_slot(slot, req, first)
        self._prefix_hits += 1
        self._prefix_blocks_shared += len(share.ref_blocks)
        self._cow_copies += int(cow)
        self._metrics.span(
            "prefix_hit", trace_id=req.trace_id, rid=req.rid, slot=slot,
            shared_blocks=len(share.ref_blocks), cow=int(cow),
            tail_tokens=n_tail)
        # touches the indexed chain and indexes any full block the tail
        # added
        self._prefix.publish(self._pool, ids_all, table)
        self._park_or_finish(slot, req, int(first[0]), table, t0,
                             (time.perf_counter() - t0) * 1e3, results)

    def _sample_first(self, req, last):
        dev = self._state.pos.device
        return sampling.sample(
            last, self._gen,
            torch.tensor([req.temperature], device=dev),
            torch.tensor([req.top_k], dtype=torch.int32, device=dev),
            torch.tensor([req.top_p], device=dev))

    def _reset_slot(self, slot, req, first) -> None:
        """Point slot ``slot``'s state entries at a freshly prefilled
        request whose first token is ``first`` ([1] on the device)."""
        st = self._state
        st.pos[slot] = req.prefill_ids.size
        st.tok[slot] = first[0]
        st.done[slot] = False
        st.temperature[slot] = req.temperature
        st.top_k[slot] = req.top_k
        st.top_p[slot] = req.top_p
        st.eos[slot] = req.eos_id
        st.budget[slot] = req.max_new_tokens - 1
        st.adapter[slot] = req.adapter

    def _park_or_finish(self, slot, req, first, blocks, t_enq, prefill_ms,
                        results) -> None:
        now = time.perf_counter()
        ttft_ms = ((now - req.t_submit) * 1e3
                   if req.t_submit is not None else prefill_ms)
        self._ttft_window.append(ttft_ms)
        self._metrics.span(
            "prefill", trace_id=req.trace_id, rid=req.rid, slot=slot,
            prefill_ms=round(prefill_ms, 3), ttft_ms=round(ttft_ms, 3))
        if first == req.eos_id or req.max_new_tokens <= 1:
            # degenerate request: done at its first token
            results[req.rid] = GeneratedResult(
                req.rid, [first], prefill_ms, prefill_ms, ttft_ms)
            self._metrics.span("retire", trace_id=req.trace_id,
                               rid=req.rid, slot=slot, tokens=1)
            self._metrics.request_done(
                rid=req.rid, tokens=1, latency_ms=prefill_ms,
                prefill_ms=prefill_ms, ttft_ms=ttft_ms,
                trace_id=req.trace_id)
            self._state.done[slot] = True
            self._release(slot, blocks)
        else:
            if blocks is not None:
                self._slot_blocks[slot] = blocks
            self._active[slot] = _Slot(req, t_enq, prefill_ms, first,
                                       ttft_ms)

    def _release(self, slot, blocks) -> None:
        """Give a retired slot's blocks back, redirecting its table rows to
        trash first: the done slot keeps writing at its frozen
        position."""
        if self._pool is None or blocks is None:
            return
        pk.retire_tables(self._state.caches, slot)
        self._pool.release(blocks)

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
            total_ms = (time.perf_counter() - st.t_start) * 1e3
            results[st.req.rid] = GeneratedResult(
                st.req.rid, st.tokens, st.prefill_ms, total_ms, st.ttft_ms)
            self._metrics.span(
                "retire", trace_id=st.req.trace_id, rid=st.req.rid,
                slot=slot, tokens=len(st.tokens))
            self._metrics.request_done(
                rid=st.req.rid, tokens=len(st.tokens), latency_ms=total_ms,
                prefill_ms=st.prefill_ms, ttft_ms=st.ttft_ms,
                trace_id=st.req.trace_id)
            self._release(slot, self._slot_blocks.pop(slot, None))
