"""Refcounted copy-on-write prefix cache over the paged KV pool
(counterpart of ``paddle_tpu/serving/prefix_cache.py``).

Once a request's prefill lands, each full prompt block (``block_size``
tokens wholly inside the prompt) becomes an immutable entry keyed by a
token-chain hash: CRC32 chained per block, so block ``j``'s key commits to
every token before it. A later request whose prompt walks the same chain
takes those physical blocks by table reference (``BlockPool.ref`` counts
the holder, nothing is copied) and the engine prefills only the unshared
tail.

Writes stay isolated by copy-on-write. A slot writes position ``p`` into
logical block ``p // bs``, so a borrower's own writes (the tail prefill,
decode appends) land in fresh blocks, except in one case: on a full-prefix
match the final prompt token is run again (the decode loop needs its
logits) and would write into the last shared block. The engine copies that
block into a private one at admission (``paged_kv.paged_splice_tail``);
no shared block is written after it was published.

Eviction is LRU over idle entries (refcount 1: only the index holds the
block); evicting a parent evicts its descendants, so no indexed child is
left unreachable. Admission charges only the unshared block demand.

Env knobs, with the JAX package's meanings: ``PADDLE_SERVE_PREFIX_CACHE``
(``1`` builds the index; default ``0``), ``PADDLE_SERVE_PREFIX_BLOCKS``
(max cached entries; ``0`` = bounded only by the pool).

Fault hook: ``lookup`` fires the ``serve`` site when a
``serve:prefix_stale:nth[:k]`` rule is armed (``utils.fault_injection``)
and then poisons the ``k``-th oldest entry (:meth:`PrefixCache.poison`),
so the next lookup misses it and pays a full prefill; stale K/V is never
served.
"""
from __future__ import annotations

import os
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Set

import numpy as np

__all__ = ["PrefixCache", "PrefixShare", "prefix_cache_enabled",
           "prefix_blocks_default", "chain_hash"]

_ENABLE_ENV = "PADDLE_SERVE_PREFIX_CACHE"
_BLOCKS_ENV = "PADDLE_SERVE_PREFIX_BLOCKS"

#: what :meth:`PrefixCache.poison` xors into an entry's key
_POISON_XOR = 0x5A5A5A5A

_ROOT = 0  # parent hash of block-0 entries


def prefix_cache_enabled() -> bool:
    """``PADDLE_SERVE_PREFIX_CACHE``: 1 builds the per-engine index."""
    return os.environ.get(_ENABLE_ENV, "0").strip().lower() in (
        "1", "true", "yes", "on")


def prefix_blocks_default() -> int:
    """``PADDLE_SERVE_PREFIX_BLOCKS``: max resident entries (0 = bounded
    only by the pool)."""
    try:
        return max(int(os.environ.get(_BLOCKS_ENV, "0")), 0)
    except ValueError:
        return 0


def chain_hash(prev: int, tokens) -> int:
    """Token-chain hash of one block: CRC32 of the block's int32 token
    bytes seeded with the previous block's hash (the JAX package's hash,
    bit for bit)."""
    return zlib.crc32(
        np.asarray(tokens, np.int32).tobytes(), int(prev)) & 0xFFFFFFFF


class PrefixShare:
    """One lookup's sharing plan, which the engine consumes at admission.

    ``src_blocks``: the matched physical blocks in logical order (what the
    prefix fetch copies into the scratch cache); ``ref_blocks``: those
    taken by table reference, at the head of the slot's table row;
    ``cow_src``: the shared block the tail's first write would land in
    (full-prefix match only, else None); ``tail_start``: the first prompt
    position the engine prefills."""

    __slots__ = ("src_blocks", "ref_blocks", "cow_src", "tail_start")

    def __init__(self, src_blocks, ref_blocks, cow_src, tail_start):
        self.src_blocks = src_blocks
        self.ref_blocks = ref_blocks
        self.cow_src = cow_src
        self.tail_start = tail_start


class _Entry:
    __slots__ = ("block", "parent")

    def __init__(self, block: int, parent: int):
        self.block = block
        self.parent = parent


class PrefixCache:
    """Per-engine chain-hash index over published prompt blocks."""

    def __init__(self, block_size: int, *, capacity: Optional[int] = None):
        self.block = int(block_size)
        self.capacity = (prefix_blocks_default() if capacity is None
                         else int(capacity))
        self._entries: "OrderedDict[int, _Entry]" = OrderedDict()
        self._children: Dict[int, Set[int]] = {}
        self.lookups = 0
        self.published = 0
        self.evicted = 0
        self.poisoned = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt_ids) -> Optional[PrefixShare]:
        """Walk the chain over the prompt's full blocks: None on a miss,
        else the sharing plan. Matched entries become most recent. An armed
        ``serve:prefix_stale`` fault poisons its entry first."""
        from ..utils import fault_injection as fi

        self.lookups += 1
        for _, arg in fi.consume_serve_matching(("prefix_stale",),
                                                fire=True):
            self.poison(arg)
        bs = self.block
        L = int(len(prompt_ids))
        h = _ROOT
        matched: List[int] = []
        for j in range(L // bs):
            h = chain_hash(h, prompt_ids[j * bs:(j + 1) * bs])
            e = self._entries.get(h)
            if e is None:
                break
            self._entries.move_to_end(h)
            matched.append(e.block)
        if not matched:
            return None
        n = len(matched)
        if n * bs == L:
            # full match: the final prompt token's forward writes position
            # L-1 inside the last shared block, so that block is copied
            return PrefixShare(matched, matched[:-1], matched[-1], L - 1)
        return PrefixShare(matched, list(matched), None, n * bs)

    def publish(self, pool, prompt_ids, table_blocks) -> int:
        """Index the full prompt blocks of a slot just prefilled.
        ``table_blocks`` is the slot's table row in logical order. Each
        newly indexed block gains one pool reference (the index's own);
        hashes already indexed only become most recent. Publishing stops,
        never skips, when the capacity bound is reached and nothing can be
        evicted, so every indexed child is reachable from its parent.
        Returns how many entries were added."""
        bs = self.block
        L = int(len(prompt_ids))
        h = _ROOT
        added = 0
        for j in range(L // bs):
            parent = h
            h = chain_hash(h, prompt_ids[j * bs:(j + 1) * bs])
            if h in self._entries:
                self._entries.move_to_end(h)
                continue
            if self.capacity and len(self._entries) >= self.capacity:
                if not self._evict_lru(pool):
                    break
            block = int(table_blocks[j])
            pool.ref([block])
            self._entries[h] = _Entry(block, parent)
            self._children.setdefault(parent, set()).add(h)
            added += 1
            self.published += 1
        return added

    def _subtree_idle(self, pool, h: int) -> bool:
        e = self._entries.get(h)
        if e is None:
            return True
        if pool.refcount(e.block) > 1:
            return False
        return all(self._subtree_idle(pool, c)
                   for c in self._children.get(h, ()))

    def _evict_entry(self, pool, h: int) -> None:
        for c in list(self._children.get(h, ())):
            self._evict_entry(pool, c)
        e = self._entries.pop(h, None)
        if e is None:
            return
        self._children.pop(h, None)
        sibs = self._children.get(e.parent)
        if sibs is not None:
            sibs.discard(h)
            if not sibs:
                self._children.pop(e.parent, None)
        pool.release([e.block])
        self.evicted += 1

    def _evict_lru(self, pool) -> bool:
        """Evict the oldest idle subtree (a borrower references every
        ancestor block too, so an idle parent has idle descendants)."""
        victim = next((h for h in self._entries
                       if self._subtree_idle(pool, h)), None)
        if victim is None:
            return False
        self._evict_entry(pool, victim)
        return True

    def evict_for(self, pool, need: int) -> int:
        """Evict until ``pool.free >= need`` or nothing can go: admission's
        last resort before it defers. Returns entries evicted."""
        n = 0
        while pool.free < int(need) and self._evict_lru(pool):
            n += 1
        return n

    def evict_above(self, pool, max_id: int) -> int:
        """Evict idle entries holding block ids above ``max_id`` (what a
        pool shrink needs). Returns entries evicted."""
        n = 0
        progress = True
        while progress:
            progress = False
            for h, e in list(self._entries.items()):
                if e.block > int(max_id) and self._subtree_idle(pool, h):
                    self._evict_entry(pool, h)
                    n += 1
                    progress = True
                    break
        return n

    def clear(self, pool) -> None:
        """Drop every entry, releasing the index's references."""
        for h in list(self._entries):
            self._evict_entry(pool, h)

    def poison(self, k: Optional[int] = None) -> bool:
        """Corrupt the key of the ``k``-th oldest entry (default 0): the
        chain walk computes the true hash and misses, so a borrower pays a
        full prefill and never adopts stale K/V. The orphaned entry stays
        refcounted until LRU eviction reclaims it."""
        keys = list(self._entries)
        if not keys:
            return False
        h = keys[min(int(k or 0), len(keys) - 1)]
        e = self._entries.pop(h)
        bad = (h ^ _POISON_XOR) & 0xFFFFFFFF
        self._entries[bad] = e
        if h in self._children:
            self._children[bad] = self._children.pop(h)
        sibs = self._children.get(e.parent)
        if sibs is not None:
            sibs.discard(h)
            sibs.add(bad)
        self.poisoned += 1
        return True
