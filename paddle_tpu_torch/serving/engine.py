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

Not ported yet (each raises): KV migration (``extract_kv``,
``insert_migrated``: ROADMAP queue A item 2(g)), the router's elastic
slots (``expand_slots``, ``retire_slots``: 2(h)) and the
``decode_metrics`` telemetry (2(i)).

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
from ..jit.decode_step import (DecodeState, DecodeStep, PrefillStep,
                               SpecDecodeState, SpeculativeDecodeStep,
                               spec_k_default)
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


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP queue A item {item}")


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
    (default) is the base model."""

    def __init__(self, prompt_ids, max_new_tokens=16, temperature=0.0,
                 top_k=0, top_p=1.0, eos_id=None, rid=None, adapter=0):
        self.prompt_ids = np.asarray(prompt_ids, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_id = -1 if eos_id is None else int(eos_id)
        self.adapter = int(adapter)
        self.rid = next(_rid_counter) if rid is None else rid
        self.t_submit: Optional[float] = None  # set by engine.submit


class GeneratedResult:
    """A finished request: generated ids and its latencies (host clock,
    ms). ``prefill_ms`` runs from the start of its prefill to its first
    token on the host; ``ttft_ms`` from submit to that token (queue wait
    and chunked prefill included)."""

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
    shares published prompt blocks between requests."""

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
        self._nmax = 0
        self._admit_deferred = 0
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

    # -- public API --------------------------------------------------------
    def needed_blocks(self, req: Request) -> int:
        """Blocks the paged pool charges ``req`` (0 when contiguous)."""
        if self._pool is None:
            return 0
        return pk.blocks_for(req.prompt_ids.size + req.max_new_tokens,
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
                self._release(slot, self._slot_blocks.pop(slot, None))
                return True
        return False

    def expand_slots(self, n: int) -> int:
        _not_ported("InferenceEngine.expand_slots (elastic slots)", "2(h)")

    def retire_slots(self, n: int) -> List[int]:
        _not_ported("InferenceEngine.retire_slots (elastic slots)", "2(h)")

    def extract_kv(self, rid):
        _not_ported("InferenceEngine.extract_kv (KV migration)", "2(g)")

    def insert_migrated(self, req: Request, bundle) -> bool:
        _not_ported("InferenceEngine.insert_migrated (KV migration)",
                    "2(g)")

    def submit(self, req: Request) -> None:
        if req.prompt_ids.size + req.max_new_tokens > self.max_length:
            raise ValueError(
                f"request {req.rid}: prompt ({req.prompt_ids.size}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds "
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
        free slots, run one decode window, collect its readback. True
        while work remains."""
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
        emits = []
        for _ in range(self.sync_every):
            emit, _, self._state = self._decode(self._state)
            emits.append(emit)
        # the readback: one stacked token transfer plus the done mask per
        # window, the only recurring device-to-host reads of the loop
        tok_block = torch.stack(emits, dim=0).cpu().numpy()
        done = self._state.done.cpu().numpy()
        self._collect(tok_block, done, results)
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
            p = job.req.prompt_ids
            t0 = time.perf_counter()
            take = min(C, p.size - job.consumed)
            chunk = np.zeros((1, C), np.int32)
            chunk[0, :take] = p[job.consumed: job.consumed + take]
            last, job.caches, _ = self._prefill(
                job.caches, chunk, [take], start=[job.consumed],
                adapter=[job.req.adapter])
            job.consumed += take
            job.prefill_s += time.perf_counter() - t0
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
                if s not in self._active and s not in self._pending]
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
                    share = self._prefix.lookup(req.prompt_ids)
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
            if share is not None:
                self._admit_shared(slot, req, share, blocks, results)
                continue
            L = req.prompt_ids.size
            if 0 < self.prefill_chunk < L:
                self._pending[slot] = _Pending(
                    req, slot, blocks, self._slot_cache(),
                    time.perf_counter())
                continue
            t0 = time.perf_counter()
            ids, lens = _pad_prompts([req.prompt_ids],
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
            self._prefix.publish(self._pool, req.prompt_ids, blocks)
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
        L = req.prompt_ids.size
        start = int(share.tail_start)
        n_tail = L - start
        # the tail window writes start .. start+W-1 and must stay inside
        # the cache: a bucket against the remaining capacity fits
        W = bucket_for(n_tail, self.max_length - start)
        ids = np.zeros((1, W), np.int32)
        ids[0, :n_tail] = req.prompt_ids[start:]
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
        # touches the indexed chain and indexes any full block the tail
        # added
        self._prefix.publish(self._pool, req.prompt_ids, table)
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
        st.pos[slot] = req.prompt_ids.size
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
        ttft_ms = (now - req.t_submit) * 1e3
        if first == req.eos_id or req.max_new_tokens <= 1:
            # degenerate request: done at its first token
            results[req.rid] = GeneratedResult(
                req.rid, [first], prefill_ms, prefill_ms, ttft_ms)
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
            results[st.req.rid] = GeneratedResult(
                st.req.rid, st.tokens, st.prefill_ms,
                (time.perf_counter() - st.t_start) * 1e3, st.ttft_ms)
            self._release(slot, self._slot_blocks.pop(slot, None))
