"""Paged KV cache: fixed-size blocks and per-slot block tables
(counterpart of ``paddle_tpu/serving/paged_kv.py``).

A contiguous serving cache is a ``[B, H, cap, Dh]`` buffer per layer: every
slot reserves its whole capacity for its whole life. A paged cache is a
pool of ``[P, H, bs, Dh]`` blocks plus a ``[B, nmax]`` int32 block table
that maps slot ``b``'s logical block ``j`` (positions ``j*bs ..
(j+1)*bs-1``) to a physical block. A request takes blocks for the tokens
it will write (``prompt + max_new_tokens``), appending never moves a row,
and a finished request's blocks go back to the pool at once.

The seam is the contiguous cache's: :data:`PagedKV` rides in
``MultiHeadAttention.Cache`` in place of a buffer, ``cache_update``
writes through the table with one ``index_put_`` and ``cached_attention``
reads through it with one gather. As the contiguous cache is written in
place, so is the pool: the functions that write return the tensors they
were given.

Physical block 0 is the trash block: a retired slot's table row is
redirected there, so the frozen-position writes a done slot keeps issuing
(the decode step's keep-alive) never land in a block that now belongs to
another request. Identity tables (``gen_cache`` without ``pool_blocks``,
the whole-batch ``generate`` shape) reserve block 0 too.

A quantized pool (``distributed.quantized_comm.QuantKV`` in place of the
``[P, H, bs, Dh]`` tensor: the int8/fp8 payload at the pool's shape and
its float32 scales ``[P, H, bs, Dh/qb]``) takes the same block layout for
both leaves: writes quantize the new rows along the head dim, reads
gather narrow and dequantize the view, and the splices copy payload and
scales alike, float8 through its bytes. ``BlockPool.grow``/``shrink``
serve the router's elastic slots, which are not ported yet.

Env knob, with the JAX package's meaning: ``PADDLE_SERVE_BLOCK_SIZE`` --
KV block size in tokens; 0 (default) keeps the contiguous cache.
"""
from __future__ import annotations

import collections
import os
from typing import List, Optional

import torch

from ..distributed import quantized_comm as qc

__all__ = [
    "PagedKV", "block_size_default", "is_paged", "num_blocks",
    "blocks_for", "paged_zero", "paged_write", "paged_gather",
    "paged_splice", "paged_splice_tail", "paged_fetch", "paged_adopt",
    "retire_tables", "pool_bytes", "worst_case_bytes", "BlockPool",
]

_BLOCK_ENV = "PADDLE_SERVE_BLOCK_SIZE"

#: a paged K or V cache: ``kv`` the [P, H, bs, Dh] block pool (a tensor, or
#: a ``QuantKV`` pair of payload and scales), ``table`` the [B, nmax] int32
#: slot -> physical-block map
PagedKV = collections.namedtuple("PagedKV", ["kv", "table"])


def block_size_default() -> int:
    """``PADDLE_SERVE_BLOCK_SIZE`` (tokens per KV block); 0 = contiguous
    cache."""
    try:
        return max(int(os.environ.get(_BLOCK_ENV, "0")), 0)
    except ValueError:
        return 0


def is_paged(cache) -> bool:
    return isinstance(cache, PagedKV)


def num_blocks(capacity: int, block: int) -> int:
    """Logical blocks a slot of ``capacity`` tokens spans (table width)."""
    return -(-int(capacity) // int(block))


def blocks_for(tokens: int, block: int) -> int:
    """Physical blocks a request writing ``tokens`` rows consumes."""
    return -(-max(int(tokens), 1) // int(block))


def _put(dst, idx, src):
    """``dst[idx] = src`` in place (``src`` cast to ``dst``'s type), float8
    through its bytes."""
    qc.bits(dst)[idx] = qc.bits(src.to(dst.dtype))


def paged_zero(batch, heads, capacity, head_dim, *, block, device,
               pool_blocks=None, dtype=None, quant=None) -> PagedKV:
    """A fresh paged K-or-V cache. With ``pool_blocks=None`` the table is
    identity-mapped (slot ``b``'s logical block ``j`` owns physical block
    ``1 + b*nmax + j``; the pool holds ``B*nmax + 1`` blocks with the
    trash block): full capacity per slot, the whole-batch ``generate``
    shape. With ``pool_blocks`` the table starts all-trash and the
    engine's :class:`BlockPool` assigns blocks per request. ``quant``
    ("int8" / "fp8") makes the pool a zero ``QuantKV``."""
    B = int(batch)
    nmax = num_blocks(capacity, block)
    if pool_blocks is None:
        P = B * nmax + 1
        table = torch.arange(1, B * nmax + 1, dtype=torch.int32,
                             device=device).reshape(B, nmax)
    else:
        P = int(pool_blocks)
        if P < 2:
            raise ValueError(
                f"pool_blocks={P}: a paged pool needs the trash block (0) "
                "plus at least one allocatable block")
        table = torch.zeros(B, nmax, dtype=torch.int32, device=device)
    shape = (P, int(heads), int(block), int(head_dim))
    if quant is not None:
        return PagedKV(qc.kv_zero(shape, quant, device=device), table)
    return PagedKV(torch.zeros(shape, dtype=dtype or torch.float32,
                               device=device), table)


def paged_write(kv, table, new, pos):
    """Write ``[B, H, Sq, D]`` K-or-V rows ``new`` at per-slot positions
    ``pos`` ([B] int) through the table, in place: position ``p`` of slot
    ``b`` lands in block ``table[b, p // bs]`` at offset ``p % bs``. One
    ``index_put_`` per tensor (a quantized pool quantizes the rows along
    the head dim first and writes payload and scales); destinations
    collide only on the trash block, where any writer may win. The caller
    keeps ``pos + Sq`` inside the slot's tabled capacity (the engine
    reserves a request's blocks at insert). Returns ``kv``."""
    B, H, Sq, _ = new.shape
    pool = qc.tensors_of(kv)[0]
    bs = int(pool.shape[2])
    idx = pos.to(torch.int64)[:, None] + torch.arange(Sq,
                                                     device=pool.device)
    blk = (idx // bs).clamp(max=int(table.shape[1]) - 1)
    phys = torch.gather(table.to(torch.int64), 1, blk).reshape(-1)
    off = (idx % bs).reshape(-1)
    news = (qc.quantize_like(kv, new) if isinstance(kv, qc.QuantKV)
            else (new,))
    for dst, u in zip(qc.tensors_of(kv), news):
        rows = qc.bits(u.to(dst.dtype)).transpose(1, 2).reshape(
            B * Sq, H, int(u.shape[-1]))
        qc.bits(dst)[phys, :, off, :] = rows
    return kv


def paged_gather(kv, table, out_dtype=None):
    """The per-slot K-or-V view ``[B, H, nmax*bs, D]`` of the pool through
    the table (one gather per tensor; a quantized pool gathers payload and
    scales and dequantizes the view to ``out_dtype``, float32 by default).
    Rows of unwritten or trash-mapped blocks are garbage; the position
    mask of ``cached_attention`` hides them."""
    def gather(pool):
        g = qc.bits(pool)[table.to(torch.int64)]  # [B, nmax, H, bs, D]
        B, nmax, H, bs, D = g.shape
        return qc.from_bits(g.transpose(1, 2).reshape(B, H, nmax * bs, D),
                            pool.dtype)

    if isinstance(kv, qc.QuantKV):
        return qc.dequantize_lastaxis(gather(kv.q), gather(kv.scale),
                                      out_dtype or torch.float32)
    out = gather(kv)
    return out if out_dtype is None else out.to(out_dtype)


def _blocks_of(contiguous, bs):
    """A batch-1 contiguous ``[1, H, cap, D]`` cache tensor as ``[cap/bs,
    H, bs, D]`` block rows."""
    _, H, cap, D = contiguous.shape
    return contiguous[0].reshape(H, cap // bs, bs, D).transpose(0, 1)


def paged_splice(paged, slot_kv, slot, table_row):
    """Write a prefilled contiguous batch-1 cache ``slot_kv`` (``[1, H,
    cap', D]``, ``cap'`` a multiple of the block size; a ``QuantKV`` for a
    quantized pool) into the pool blocks ``table_row`` names (``[nmax]``
    int, trash-padded past the slot's allocation) and point slot
    ``slot``'s table row at them, in place. Trash-padded entries collide
    on block 0. Returns ``paged``."""
    kv, table = paged
    row = torch.as_tensor(table_row, dtype=torch.int64,
                          device=table.device)
    for pool, one in zip(qc.tensors_of(kv), qc.tensors_of(slot_kv)):
        rows = _blocks_of(one, int(pool.shape[2]))
        _put(pool, row[: rows.shape[0]], rows)
    table[slot] = row.to(table.dtype)
    return paged


def paged_fetch(paged, slot_kv, table_row):
    """The inverse of :func:`paged_splice`: copy the pool blocks
    ``table_row`` names into the contiguous batch-1 cache ``slot_kv``, in
    place, so a tail prefill's attention sees the cached prefix at
    positions ``0 .. start-1`` (rows of trash-mapped entries are garbage
    the position mask hides). Returns ``slot_kv``."""
    row = torch.as_tensor(table_row, dtype=torch.int64,
                          device=paged.table.device)
    for pool, one in zip(qc.tensors_of(paged.kv), qc.tensors_of(slot_kv)):
        bs = int(pool.shape[2])
        _, H, cap, D = one.shape
        g = qc.bits(pool)[row[: cap // bs]]  # [nmax, H, bs, D]
        qc.bits(one)[0].copy_(g.transpose(0, 1).reshape(H, cap, D))
    return slot_kv


def paged_splice_tail(paged, slot_kv, slot, table_row, start, length,
                      cow_src, cow_dst):
    """The splice of a shared-prefix admission: write only positions
    ``start <= p < length`` of the prefilled contiguous batch-1 cache.
    Positions below ``start`` live in refcounted prefix-cache blocks that
    ``table_row`` references, and writing them would change every other
    reader's K/V. When the tail's first write falls inside a shared block
    (the full-prefix match), the caller passes ``cow_src``/``cow_dst``:
    the shared block is copied into the request's private ``cow_dst``
    first, then the tail rows overlay it (copy-on-write; a quantized pool
    copies payload and scales). ``cow_src = cow_dst = 0`` (the trash block
    onto itself) is the no-copy case. Dead positions go to the trash
    block. In place; returns ``paged``."""
    kv, table = paged
    row = torch.as_tensor(table_row, dtype=torch.int64,
                          device=table.device)
    for pool, one in zip(qc.tensors_of(kv), qc.tensors_of(slot_kv)):
        bs = int(pool.shape[2])
        cap = int(one.shape[2])
        raw = qc.bits(pool)
        raw[int(cow_dst)] = raw[int(cow_src)].clone()
        p = torch.arange(cap, device=pool.device)
        live = (p >= int(start)) & (p < int(length))
        phys = torch.where(live, row[p // bs], 0)
        _put(pool, (phys, slice(None), p % bs, slice(None)),
             one[0].transpose(0, 1))
    table[slot] = row.to(table.dtype)
    return paged


def paged_adopt(paged, rows, slot, table_row):
    """Adopt gathered block rows ``[nmax, H, bs, D]`` (zero-padded to the
    table width; a ``(payload, scales)`` pair for a quantized pool, adopted
    narrow) into the blocks ``table_row`` names and point slot ``slot`` at
    them, in place: the splice of a migrated KV bundle. The migration plane
    itself (``serving/kv_migration.py``) is ROADMAP queue A item 2(g).
    Returns ``paged``."""
    kv, table = paged
    row = torch.as_tensor(table_row, dtype=torch.int64,
                          device=table.device)
    if not isinstance(kv, qc.QuantKV):
        rows = (rows[0] if isinstance(rows, (tuple, list)) else rows,)
    for pool, r in zip(qc.tensors_of(kv), rows):
        _put(pool, row, torch.as_tensor(r).to(pool.device))
    table[slot] = row.to(table.dtype)
    return paged


def _paged_leaves(tree):
    if isinstance(tree, PagedKV):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for sub in tree:
            yield from _paged_leaves(sub)


def retire_tables(cache_tree, slot: int):
    """Redirect slot ``slot``'s table rows to the trash block across a
    whole cache tree, in place, once per retired request: after its
    blocks return to the pool, the done slot's keep-alive writes land in
    trash and not in a block a new request may already hold. Returns
    ``cache_tree``."""
    for leaf in _paged_leaves(cache_tree):
        leaf.table[slot] = 0
    return cache_tree


# ---------------------------------------------------------------------------
# host-side block pool: alloc and free are scheduling decisions, once per
# request, never per token
# ---------------------------------------------------------------------------


class BlockPool:
    """Free list over physical blocks ``1 .. P-1`` (0 is trash), with
    reference counts.

    The engine allocates a request's whole block budget at insert
    (``prompt + max_new_tokens`` is known at submit), so appending never
    allocates and admission is one ``free >= needed`` check. A block from
    :meth:`alloc` starts at one reference; the prefix cache's :meth:`ref`
    adds one for each further holder (the index, each borrowing slot);
    :meth:`release` drops one and frees the block only at zero."""

    def __init__(self, total_blocks: int):
        if int(total_blocks) < 2:
            raise ValueError("BlockPool needs >= 2 blocks (incl. trash)")
        self.total = int(total_blocks) - 1  # allocatable (sans trash)
        self._free: List[int] = list(range(1, int(total_blocks)))
        self._refs: dict = {}
        self.freed_total = 0

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.total - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` blocks, or None when the pool cannot cover them (nothing
        is taken; the caller defers admission)."""
        if n > len(self._free):
            return None
        taken, self._free = self._free[:n], self._free[n:]
        for b in taken:
            self._refs[b] = 1
        return taken

    def ref(self, blocks: List[int]) -> None:
        """Add one reference to each block."""
        for b in blocks:
            self._refs[b] = self._refs.get(b, 1) + 1

    def refcount(self, block: int) -> int:
        """References on an allocated block (0 if free)."""
        return self._refs.get(int(block), 0)

    def release(self, blocks: List[int]) -> None:
        """Drop one reference per block; a block rejoins the free list (and
        counts toward ``freed_total``) at zero."""
        for b in blocks:
            n = self._refs.get(b, 1) - 1
            if n <= 0:
                self._refs.pop(b, None)
                self.freed_total += 1
                self._free.append(b)
            else:
                self._refs[b] = n


# ---------------------------------------------------------------------------
# byte accounting: static shape arithmetic
# ---------------------------------------------------------------------------


def pool_bytes(cache_tree) -> int:
    """Bytes of every tensor in a cache tree (pools and tables, or
    contiguous buffers): shape arithmetic, no device read."""
    if isinstance(cache_tree, torch.Tensor):
        return cache_tree.numel() * cache_tree.element_size()
    if isinstance(cache_tree, (list, tuple)):
        return sum(pool_bytes(sub) for sub in cache_tree)
    return 0


def worst_case_bytes(batch, heads, capacity, head_dim, itemsize=4,
                     layers=1) -> int:
    """What the contiguous layout reserves for the same slots: K and V at
    ``[B, H, cap, Dh]`` per layer."""
    return (2 * int(layers) * int(batch) * int(heads) * int(capacity)
            * int(head_dim) * int(itemsize))
