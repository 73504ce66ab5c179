"""Block-scaled int8 / fp8-e4m3 quantization, the quantized gradient
allreduce and the quantized KV-cache layout (counterpart of
``paddle_tpu/distributed/quantized_comm.py``; the allreduce of its lines
144-206, the byte record of 312-329).

Symmetric per-block scales: each block's scale is ``amax / qmax`` (127
for int8, 448 for float8_e4m3fn, its largest finite value), the payload
``x / scale`` rounded half to even and clipped (int8) or cast (fp8: the
scale maps the block's amax onto 448, so nothing saturates), in the JAX
package's order of operations, so both packages give the same bytes. An
all-zero block gets scale 0 and dequantizes to exact zeros.

torch lacks ``scatter_`` and ``gather`` for ``float8_e4m3fn``; the cache
code moves fp8 payloads through :func:`bits` (a ``uint8`` view of the same
bytes, which is bit-exact).

**The gradient's two forms.** :func:`quantize_dequantize` is the boundary
round trip (one pass through the quantizer, back at the value's own type:
the width policy of a reduction with no explicit dcn hop).
:func:`quantized_allreduce` is the wire-true exchange over a group of
ranks: each rank quantizes its value, the group all-gathers the payloads
and their float32 scales, and each rank widens every peer's contribution
and sums them in float32 (then divides by the group's size), so the
reduction never runs in the narrow type. Payload and scales travel as one
``uint8`` buffer of ``n + 4 * ceil(n / block)`` bytes for ``n`` values
(the payload without its last block's padding; :func:`wire_bytes`): one
``all_gather_into_tensor`` a gradient, which gloo takes for CUDA tensors
as it does for CPU ones. The comm monitor counts that exchange as op
``quantized_allreduce`` with the bytes this rank hands the transport, as
it counts an ``all_reduce`` by its operand's bytes.
"""
from __future__ import annotations

import os
from collections import namedtuple

import torch

__all__ = [
    "SUPPORTED", "fp8_dtype", "resolve_policy", "bits", "from_bits",
    "quantize_blockwise", "dequantize_blockwise", "quantize_along",
    "dequantize_along", "quantize_lastaxis", "dequantize_lastaxis",
    "quantize_dequantize", "quantized_allreduce", "quantized_pmean",
    "QuantKV", "tensors_of", "quantize_like", "kv_quant_policy", "kv_zero",
    "wire_bytes", "grad_comm_info",
]

#: the quantized widths the policies accept
SUPPORTED = ("int8", "fp8")

#: symmetric int8 range: +-127 (-128 is never emitted, so sign(q) ==
#: sign(x))
_INT8_QMAX = 127.0
#: largest finite float8_e4m3fn value
_FP8_QMAX = 448.0


def fp8_dtype():
    """``torch.float8_e4m3fn`` where this torch has it, else None."""
    return getattr(torch, "float8_e4m3fn", None)


def resolve_policy(value, block=128, *, knob="quantized_allreduce"):
    """A (dtype, block) knob pair -> ("int8" | "fp8", block) or None.
    Raises on an unknown width, on fp8 where this torch lacks the type and
    on a block width below 1: computing at another width than asked is
    the one failure a width policy must not have. ``knob`` names the
    setting in the error."""
    if value is None or value is False or value == "":
        return None
    v = str(value).strip().lower()
    if v not in SUPPORTED:
        raise ValueError(f"{knob}={value!r}: supported policies are "
                         f"{SUPPORTED} (or None to disable)")
    if v == "fp8" and fp8_dtype() is None:
        raise NotImplementedError(
            f"{knob}='fp8' needs torch.float8_e4m3fn, which this torch "
            "does not provide; use 'int8'")
    b = int(block)
    if b <= 0:
        raise ValueError(f"{knob}_block={block} must be a positive block "
                         "width")
    return v, b


def _qparams(dtype: str):
    if dtype == "int8":
        return torch.int8, _INT8_QMAX
    if dtype == "fp8":
        f8 = fp8_dtype()
        if f8 is None:
            raise NotImplementedError("no float8_e4m3fn in this torch")
        return f8, _FP8_QMAX
    raise ValueError(f"unknown quantization dtype {dtype!r}")


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` for an index op: a float8 payload as a ``uint8`` view of its
    bytes (torch's scatter and gather lack float8), any other tensor as
    it is."""
    return t.view(torch.uint8) if t.dtype == fp8_dtype() else t


def from_bits(t: torch.Tensor, dtype) -> torch.Tensor:
    """The inverse of :func:`bits`: ``t`` (bytes, or a tensor already of
    its type) as a tensor of ``dtype``."""
    return t.view(dtype) if dtype == fp8_dtype() else t


def _scales(amax, qmax):
    """``amax / qmax``, divided as IEEE division: CUDA divides a tensor by
    a host scalar as a product with its reciprocal, which can land one
    ulp away, so the divisor is a tensor on ``amax``'s device."""
    return amax / torch.full((), qmax, dtype=torch.float32,
                             device=amax.device)


def _encode(x32, scale, qdtype, qmax):
    """Scale, then narrow (``x32`` float32, ``scale`` broadcastable):
    int8 rounds half to even and clips; fp8 is a plain cast."""
    y = x32 / torch.where(scale > 0, scale, 1.0)
    if qdtype == torch.int8:
        return torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    return y.to(qdtype)


def quantize_blockwise(x, dtype: str = "int8", block: int = 128):
    """``x`` (any shape) -> (payload ``[nb, block]`` narrow, scales
    ``[nb]`` float32): flattened, zero-padded to whole blocks, one scale
    per block."""
    qdtype, qmax = _qparams(dtype)
    flat = x.reshape(-1).to(torch.float32)
    n = int(flat.shape[0])
    nb = -(-n // block)
    flat = torch.nn.functional.pad(flat, (0, nb * block - n))
    xb = flat.reshape(nb, block)
    scales = _scales(xb.abs().amax(dim=1), qmax)
    return _encode(xb, scales[:, None], qdtype, qmax), scales


def _widen(payload, scales):
    """``payload`` (float32 where it is not int8) times its broadcast
    ``scales``: for int8 one pass, the widening inside the product (type
    promotion reads the int8 bytes and writes float32 once)."""
    if payload.dtype != torch.int8:
        payload = payload.to(torch.float32)
    return payload * scales.to(torch.float32)


def dequantize_blockwise(payload, scales, shape, out_dtype=torch.float32):
    """The inverse of :func:`quantize_blockwise`, back onto ``shape``."""
    flat = _widen(payload, scales[:, None])
    n = 1
    for d in shape:
        n *= int(d)
    return flat.reshape(-1)[:n].reshape(tuple(shape)).to(out_dtype)


def quantize_dequantize(x, dtype: str = "int8", block: int = 128):
    """The boundary round trip: ``x`` passes the block quantizer once and
    comes back at its own type and shape."""
    p, s = quantize_blockwise(x, dtype, block)
    return dequantize_blockwise(p, s, x.shape, x.dtype)


def _hop_group(group):
    """A Group, a group id, or a mesh axis name (``"dcn"``: this rank's
    group along that axis of the hybrid mesh)."""
    from . import collective, comm

    if isinstance(group, str):
        mesh = comm.hybrid_mesh()
        if mesh is None:
            raise ValueError(f"quantized_allreduce over axis {group!r} "
                             "needs a hybrid mesh")
        return mesh.group(group)
    return collective._group(group)


class QuantizedWork:
    """An issued :func:`quantized_allreduce`: :meth:`wait` completes the
    gather and returns the reduced tensor (at the input's type and
    shape)."""

    def __init__(self, x, work, gathered, nb, block, qdtype, mean, n):
        self._x, self._work, self._gathered = x, work, gathered
        self._nb, self._block, self._qdtype = nb, block, qdtype
        self._mean, self._n = mean, n

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
        n, nb, block = self._n, self._nb, self._block
        size = self._x.numel()
        rows = self._gathered.view(n, -1)
        # the payload crossed unpadded: the last block's tail is zeros
        payload = torch.nn.functional.pad(
            rows[:, :size], (0, nb * block - size)).view(self._qdtype) \
            .reshape(n, nb, block)
        scales = rows[:, size:].contiguous().view(torch.float32)
        contrib = _widen(payload, scales[..., None])  # [n, nb, block]
        total = contrib.sum(dim=0)                     # float32 master sum
        if self._mean:
            total = total / n
        x = self._x
        return total.reshape(-1)[:x.numel()].reshape(x.shape).to(x.dtype)


def quantized_allreduce(x, group=None, *, dtype: str = "int8",
                        block: int = 128, mean: bool = True,
                        async_op: bool = False):
    """The block-quantized allreduce of ``x`` over ``group`` (a Group,
    its id, or a mesh axis name such as ``"dcn"``): quantize here,
    all-gather payload and scales, widen each peer's contribution, sum in
    float32 (the mean with ``mean``), cast back to ``x``'s type. Every rank
    of the group gets the same bytes back. With ``async_op`` it returns a
    :class:`QuantizedWork` whose ``wait()`` gives the result."""
    from . import collective

    g = _hop_group(group)
    qdtype, _ = _qparams(dtype)
    payload, scales = quantize_blockwise(x, dtype, block)
    nb = int(scales.shape[0])
    buf = torch.cat([bits(payload).reshape(-1)[:x.numel()]
                     .view(torch.uint8), scales.view(torch.uint8)])
    out, work = collective.all_gather_async_(buf, g, op="quantized_allreduce")
    w = QuantizedWork(x, work, out, nb, block, qdtype, mean, g.nranks)
    return w if async_op else w.wait()


def quantized_pmean(x, group=None, *, dtype: str = "int8",
                    block: int = 128):
    """The JAX package's form for its partial-manual regions: each rank's
    value through :func:`quantize_dequantize`, then a full-width mean over
    ``group``. The port's step uses :func:`quantized_allreduce` (a process
    group has no such limit); this keeps the public name and its
    numbers."""
    from . import collective

    q = quantize_dequantize(x, dtype, block).contiguous()
    return collective.all_reduce_(q, collective.ReduceOp.AVG,
                                  _hop_group(group))


def _axis_block(d: int, block: int) -> int:
    """The block width along an axis of length ``d``: ``block`` when it
    tiles ``d``, else the whole axis (a head dim of 64 under block 128
    gets one scale per row: per token and head in a KV cache)."""
    return block if (block > 0 and d % block == 0) else d


def _split_axis(shape, a: int, nb: int):
    """``shape`` with axis ``a`` split into ``(nb, shape[a] // nb)``."""
    shape = tuple(shape)
    return shape[:a] + (nb, shape[a] // nb) + shape[a + 1:]


def quantize_along(x, dtype: str = "int8", block: int = 128, axis=-1):
    """``x`` -> (payload at ``x``'s shape narrow, float32 scales at
    ``x``'s shape with ``axis`` cut to ``D/bs``): blocks of ``bs`` along
    ``axis`` (``block`` when it tiles the axis, else the whole axis).
    The KV cache quantizes along the last axis (per token and head), a
    linear weight ``[in, out]`` along the contraction axis 0."""
    qdtype, qmax = _qparams(dtype)
    a = axis % x.dim()
    bs = _axis_block(int(x.shape[a]), block)
    xr = x.to(torch.float32).reshape(
        _split_axis(x.shape, a, int(x.shape[a]) // bs))
    scales = _scales(xr.abs().amax(dim=a + 1), qmax)
    payload = _encode(xr, scales.unsqueeze(a + 1), qdtype, qmax)
    return payload.reshape(x.shape), scales


def dequantize_along(payload, scales, out_dtype=torch.float32, axis=-1):
    """The inverse of :func:`quantize_along`."""
    a = axis % payload.dim()
    pr = payload.reshape(_split_axis(payload.shape, a, int(scales.shape[a])))
    out = _widen(pr, scales.unsqueeze(a + 1))
    return out.reshape(payload.shape).to(out_dtype)


def quantize_lastaxis(x, dtype: str = "int8", block: int = 128):
    """``x [..., D]`` -> (payload ``[..., D]`` narrow, scales ``[...,
    D/bs]`` float32), :func:`quantize_along` the last axis, so a ``[B, H,
    cap, Dh]`` KV buffer keeps its shape and its scales ride a parallel
    ``[B, H, cap, nb]`` buffer."""
    return quantize_along(x, dtype, block, axis=-1)


def dequantize_lastaxis(payload, scales, out_dtype=torch.float32):
    """The inverse of :func:`quantize_lastaxis`."""
    return dequantize_along(payload, scales, out_dtype, axis=-1)


#: a quantized K or V cache buffer: ``q`` the narrow payload at the cache's
#: shape, ``scale`` the float32 per-block scales ``[..., Dh/bs]``
QuantKV = namedtuple("QuantKV", ["q", "scale"])


def tensors_of(buf):
    """The tensors of one K or V cache buffer or pool: payload and scales
    of a :class:`QuantKV`, else the one tensor."""
    return list(buf) if isinstance(buf, QuantKV) else [buf]


def quantize_like(buf: QuantKV, new):
    """Quantize ``new`` rows as the :class:`QuantKV` buffer ``buf`` holds
    them: its payload's width, its block (head dim / scales per row)."""
    bs = int(buf.q.shape[-1]) // int(buf.scale.shape[-1])
    width = "int8" if buf.q.dtype == torch.int8 else "fp8"
    return quantize_lastaxis(new, width, bs)


def kv_quant_policy(dtype):
    """A ``gen_cache(dtype=)`` request, or with no dtype the
    ``PADDLE_SERVE_KV_QUANT`` env default -> "int8" | "fp8" | None. A
    value that names no policy (a torch dtype, or unset) gives None: the
    caller builds the full-width cache. The env knob takes policy names
    only, and raises on any other value."""
    v = dtype
    if v is None:
        env = os.environ.get("PADDLE_SERVE_KV_QUANT", "").strip().lower()
        if not env or env in ("0", "off", "false", "none"):
            return None
        if env not in SUPPORTED:
            raise ValueError(f"PADDLE_SERVE_KV_QUANT={env!r}: supported "
                             f"values are {SUPPORTED} (or 0/off)")
        v = env
    if isinstance(v, str) and v.lower() in SUPPORTED:
        v = v.lower()
        if v == "fp8" and fp8_dtype() is None:
            raise NotImplementedError(
                "PADDLE_SERVE_KV_QUANT/gen_cache dtype 'fp8' needs "
                "torch.float8_e4m3fn, which this torch does not provide; "
                "use 'int8'")
        return v
    return None


def kv_zero(shape, dtype: str = "int8", block: int = 128, *, device):
    """A zero :class:`QuantKV` for a fresh quantized cache buffer of
    ``shape`` ``[..., Dh]``: zero scales dequantize to exact zeros, as the
    float cache's zero fill."""
    qdtype, _ = _qparams(dtype)
    d = int(shape[-1])
    bs = _axis_block(d, block)
    raw = torch.uint8 if qdtype == fp8_dtype() else qdtype
    return QuantKV(
        # zero bytes are +0 in both widths
        from_bits(torch.zeros(tuple(shape), dtype=raw, device=device),
                  qdtype),
        torch.zeros(tuple(shape[:-1]) + (d // bs,), dtype=torch.float32,
                    device=device))


def wire_bytes(n_elems: int, dtype, block: int = 128) -> int:
    """Bytes of ``n_elems`` values under a width policy: one byte per value
    plus a float32 scale per block for int8/fp8; the type's width for a
    full-width type. Shape arithmetic, no device read."""
    if dtype in SUPPORTED:
        nb = -(-int(n_elems) // int(block))
        return int(n_elems) + 4 * nb
    itemsize = {"float32": 4, "bfloat16": 2, "float16": 2}.get(
        str(dtype), 4)
    return int(n_elems) * itemsize


def grad_comm_info(n_elems: int, policy=None, *,
                   fp16_allreduce: bool = False,
                   hierarchical: bool = False) -> dict:
    """The static ``grad_comm`` record of one gradient reduction: its type
    and bytes on the wire (payload and scales) beside the float32
    baseline. ``policy`` is a :func:`resolve_policy` pair or None. With
    ``hierarchical`` the record adds ``hops``, each hop priced at its own
    width: ``ici`` at full width (float32, or bfloat16 under
    ``fp16_allreduce``), ``dcn`` at the policy's."""
    if policy is not None:
        dtype, block = policy
    else:
        dtype, block = ("bfloat16" if fp16_allreduce else "float32"), 0
    wire = wire_bytes(n_elems, dtype, block or 128)
    f32 = 4 * int(n_elems)
    out = {
        "dtype": dtype,
        "block": int(block),
        "grad_elems": int(n_elems),
        "bytes_on_wire": int(wire),
        "bytes_f32": int(f32),
        "reduction_x": round(f32 / wire, 2) if wire else 1.0,
    }
    if hierarchical:
        full = "bfloat16" if fp16_allreduce else "float32"
        out["hops"] = {
            "ici": {"dtype": full,
                    "bytes_on_wire": wire_bytes(n_elems, full)},
            "dcn": {"dtype": dtype, "bytes_on_wire": int(wire)}}
    return out
