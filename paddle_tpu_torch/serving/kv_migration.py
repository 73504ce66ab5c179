"""KV block migration (counterpart of ``paddle_tpu/serving/kv_migration.py``).

A request's live KV blocks move to another engine (or another slot of the
same engine) as data; the receiver splices them into its pool and decodes
on mid-sentence with no prefill. The unit of transfer is the
:class:`KVBundle`:

- **leaves**: for every ``paged_kv.PagedKV`` buffer of the cache (layer
  0's K, layer 0's V, layer 1's K, ...), the request's physical blocks
  gathered through its table into an ``[n, H, bs, D]`` CPU tensor; a
  quantized pool contributes its payload and its scales, narrow (the
  bundle never dequantizes, so an int8/fp8 cache moves bit-exact);
- **manifest**: what the receiver needs to resume the request, as host
  values: rid, prompt/resume/emitted tokens, ``ctx`` (cache rows
  written), the last emitted token (the next step's feed), the sampling
  parameters, the remaining budget, the block size and quant policy, the
  adapter, and one CRC32 per block over the bytes of that block's row of
  every leaf.

The wire form (:meth:`KVBundle.to_wire`, the mailbox blob) is the JAX
package's byte for byte: a blob written by either package reads in the
other. A float8 or bfloat16 leaf travels as its raw bytes under the JAX
package's dtype name (``float8_e4m3fn``, ``bfloat16``) and is viewed as
the torch type on the way in.

Env knobs, with the JAX package's meanings:
  ``PADDLE_SERVE_MIGRATE``               1 = migrate first on failover,
                                         drain and slot retirement
                                         (default); 0 = always re-prefill
  ``PADDLE_SERVE_MIGRATE_TIMEOUT_MS``    mailbox blob arrival deadline (500)
  ``PADDLE_SERVE_MIGRATE_COST_TOKENS``   flat transfer cost in
                                         token-equivalents (3)
  ``PADDLE_SERVE_MIGRATE_COST_PER_KCTX`` added cost per 1k tokens of
                                         context (1.0)
"""
from __future__ import annotations

import base64
import json
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed import quantized_comm as qc
from . import paged_kv as pk

__all__ = [
    "KVBundle", "gather_leaves", "block_crcs", "migrate_enabled",
    "migrate_timeout_ms_default", "migrate_cost_tokens",
]

_ENABLE_ENV = "PADDLE_SERVE_MIGRATE"
_TIMEOUT_ENV = "PADDLE_SERVE_MIGRATE_TIMEOUT_MS"
_COST_FLAT_ENV = "PADDLE_SERVE_MIGRATE_COST_TOKENS"
_COST_KCTX_ENV = "PADDLE_SERVE_MIGRATE_COST_PER_KCTX"


def migrate_enabled() -> bool:
    """``PADDLE_SERVE_MIGRATE``: block migration as the fast path of
    failover, drain and slot retirement (default on); off = every
    recovery re-prefills."""
    return os.environ.get(_ENABLE_ENV, "1").lower() not in (
        "0", "false", "off")


def migrate_timeout_ms_default() -> float:
    """``PADDLE_SERVE_MIGRATE_TIMEOUT_MS``: how long the router waits for
    a mailbox bundle blob before it re-prefills (default 500). The
    in-process path never waits."""
    try:
        return max(float(os.environ.get(_TIMEOUT_ENV, "500")), 1.0)
    except ValueError:
        return 500.0


def migrate_cost_tokens(ctx: int) -> float:
    """The drain decision's price of moving ``ctx`` tokens of KV, in
    token-equivalents (comparable to the tokens left to decode in place):
    ``PADDLE_SERVE_MIGRATE_COST_TOKENS`` flat plus
    ``PADDLE_SERVE_MIGRATE_COST_PER_KCTX`` per 1k tokens of context."""
    try:
        flat = float(os.environ.get(_COST_FLAT_ENV, "3"))
    except ValueError:
        flat = 3.0
    try:
        per_kctx = float(os.environ.get(_COST_KCTX_ENV, "1.0"))
    except ValueError:
        per_kctx = 1.0
    return max(flat, 0.0) + max(int(ctx), 0) * max(per_kctx, 0.0) / 1e3


# ---------------------------------------------------------------------------
# leaf gather and per-block CRC
# ---------------------------------------------------------------------------


def gather_leaves(cache_tree, blocks: Sequence[int]) -> List[Tuple]:
    """Gather physical blocks ``blocks`` out of every ``PagedKV`` buffer of
    a cache tree: one tuple of CPU tensors per buffer, ``(payload,)`` of
    ``[n, H, bs, D]`` or ``(payload, scales)`` for a quantized pool, both
    narrow. One gather and one device-to-host copy per tensor per
    migration."""
    out: List[Tuple] = []
    for leaf in pk.paged_leaves(cache_tree):
        idx = torch.as_tensor(list(blocks), dtype=torch.int64,
                              device=leaf.table.device)
        out.append(tuple(
            qc.from_bits(qc.bits(t)[idx].cpu(), t.dtype)
            for t in qc.tensors_of(leaf.kv)))
    return out


def _row_bytes(t: torch.Tensor) -> np.ndarray:
    """``t`` ([n, ...]) as an [n, bytes] uint8 array of its raw bytes."""
    t = t.detach().contiguous()
    return t.reshape(-1).view(torch.uint8).numpy().reshape(t.shape[0], -1)


def block_crcs(leaves: List[Tuple], n_blocks: int) -> List[int]:
    """CRC32 per logical block: block ``b``'s checksum chains over row
    ``b`` of every tensor of every leaf (payload, then scales), so a flip
    anywhere in the block's bytes names exactly that block."""
    rows = [_row_bytes(t) for leaf in leaves for t in leaf]
    crcs = []
    for b in range(int(n_blocks)):
        c = 0
        for r in rows:
            c = zlib.crc32(r[b].tobytes(), c)
        crcs.append(int(c) & 0xFFFFFFFF)
    return crcs


# ---------------------------------------------------------------------------
# wire form (the mailbox blob; the JAX package's, byte for byte)
# ---------------------------------------------------------------------------

#: the JAX package's dtype names (numpy's, and ml_dtypes' for the types
#: numpy lacks) of the leaves a bundle carries <-> torch types
_WIRE_DTYPES = {
    "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8,
    "int32": torch.int32,  # the simulated worker's token blocks
}
if qc.fp8_dtype() is not None:
    _WIRE_DTYPES["float8_e4m3fn"] = qc.fp8_dtype()
_WIRE_NAMES = {v: k for k, v in _WIRE_DTYPES.items()}


def _arr_wire(t: torch.Tensor) -> dict:
    t = t.detach().contiguous()
    return {
        "dtype": _WIRE_NAMES[t.dtype],
        "shape": [int(d) for d in t.shape],
        "data": base64.b64encode(
            t.reshape(-1).view(torch.uint8).numpy().tobytes()
        ).decode("ascii"),
    }


def _arr_unwire(d: dict) -> torch.Tensor:
    name = d["dtype"]
    if name not in _WIRE_DTYPES:
        raise ValueError(f"KV bundle leaf of dtype {name!r}: this torch "
                         "has no such type")
    raw = np.frombuffer(base64.b64decode(d["data"]), np.uint8).copy()
    return torch.from_numpy(raw).view(_WIRE_DTYPES[name]).reshape(
        d["shape"])


class KVBundle:
    """One request's migratable KV: ``leaves`` (per-``PagedKV`` tuples of
    CPU tensors, see :func:`gather_leaves`) and ``manifest`` (resume state
    and per-block CRCs). The in-process path hands it across directly; the
    mailbox path round-trips it through :meth:`write_blob` /
    :meth:`read_blob`."""

    def __init__(self, manifest: Dict, leaves: List[Tuple]):
        self.manifest = dict(manifest)
        self.leaves = [tuple(leaf) for leaf in leaves]

    @property
    def n_blocks(self) -> int:
        return int(self.manifest.get("n_blocks", 0))

    @property
    def nbytes(self) -> int:
        return sum(int(t.numel()) * int(t.element_size())
                   for leaf in self.leaves for t in leaf)

    def seal(self) -> "KVBundle":
        """Stamp the per-block CRCs into the manifest (the sending side)."""
        self.manifest["crcs"] = block_crcs(self.leaves, self.n_blocks)
        return self

    def verify(self) -> List[int]:
        """Indices of blocks whose bytes no longer match their sealed CRC
        (empty = intact). Any bad block fails the whole bundle."""
        want = list(self.manifest.get("crcs") or [])
        have = block_crcs(self.leaves, self.n_blocks)
        return [b for b in range(self.n_blocks)
                if b >= len(want) or want[b] != have[b]]

    def flip_bit(self, block: Optional[int] = None) -> int:
        """Flip one payload bit of block ``block`` (default 0), in place:
        the hand of ``serve:kv_corrupt:nth[:block]``. Returns the block
        flipped."""
        b = int(block or 0) % max(self.n_blocks, 1)
        t = self.leaves[0][0]
        raw = t.reshape(-1).view(torch.uint8).reshape(t.shape[0], -1)
        raw[b, 0] ^= 1
        return b

    def to_wire(self) -> dict:
        return {
            "v": 1,
            "manifest": self.manifest,
            "leaves": [[_arr_wire(t) for t in leaf]
                       for leaf in self.leaves],
        }

    @classmethod
    def from_wire(cls, d: dict) -> "KVBundle":
        return cls(d.get("manifest") or {},
                   [tuple(_arr_unwire(a) for a in leaf)
                    for leaf in d.get("leaves") or []])

    def write_blob(self, path: str) -> None:
        """Atomic JSON blob write (temporary file, then replace: a reader
        never sees a torn bundle)."""
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_wire(), f)
        os.replace(tmp, path)

    @classmethod
    def read_blob(cls, path: str) -> "KVBundle":
        with open(path) as f:
            return cls.from_wire(json.load(f))
