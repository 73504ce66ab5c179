"""Quantized weight checkpoints (the quantized half of
``paddle_tpu/jit/save_load.py``): ``save_quantized`` / ``load_quantized``.

The file format is the JAX package's own, so a checkpoint written by
either package loads into the other: ``path + ".pdqparams"``, an npz of
``name::q`` (int8 payload, or the fp8 payload's bytes as uint8) and
``name::scale`` (float32 scales) for every linear weight in paddle's
``[in, out]`` layout (the port's own), plain ``name`` entries for the
wide rest (embeddings, norms, biases, persistent buffers); and ``path +
".pdqmeta"``, a JSON record ``{"format": "pdq1", "dtype", "block",
"quantized": [names], "bytes_payload", "bytes_scales", "bytes_wide"}``.
The arrays cross as they are, an fp8 payload as its uint8 bytes.

Not ported yet: ``save``, ``load`` and ``TranslatedLayer`` (ROADMAP queue A
item 6), and the ``q_checkpoint`` bus record (item 8).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..distributed import quantized_comm as qc
from ..distributed import quantized_compute as qcp

__all__ = ["QPARAMS_SUFFIX", "QMETA_SUFFIX", "save_quantized",
           "load_quantized"]

QPARAMS_SUFFIX = ".pdqparams"
QMETA_SUFFIX = ".pdqmeta"
#: the key suffixes of a linear weight's quantized pair
Q_SUFFIXES = ("::q", "::scale")


@torch.no_grad()
def save_quantized(layer, path, dtype: str = "int8", block: int = 128):
    """Write ``layer``'s weights as an int8/fp8 checkpoint: every linear
    weight (``quantized_compute.iter_quantizable``) as its narrow payload
    and per-block float32 scales, everything else of the state dict wide.
    A narrow weight's payload is written as it is; wide weights are
    quantized one at a time. Returns the meta record."""
    pol = qc.resolve_policy(dtype, block, knob="save_quantized")
    if pol is None:
        raise ValueError("save_quantized needs an explicit 'int8'/'fp8'")
    dt, bs = pol
    state, qnames = {}, []
    b_payload = b_scales = 0
    for pname, _, w in qcp.iter_quantizable(layer):
        scales = qcp.scale_of(w)
        payload = w
        if scales is None:
            payload, scales = qcp.quantize_weight(w.detach(), dt, bs)
        state[f"{pname}::q"] = payload
        state[f"{pname}::scale"] = scales
        qnames.append(pname)
        b_payload += payload.numel()
        b_scales += 4 * scales.numel()
    for name, t in layer.state_dict().items():
        if name not in qnames:
            state[name] = t
    arrays = {n: np.array(qc.bits(t.detach()).cpu().numpy())
              for n, t in state.items()}
    b_wide = sum(a.nbytes for n, a in arrays.items()
                 if not n.endswith(Q_SUFFIXES))
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path + QPARAMS_SUFFIX, "wb") as f:
        np.savez(f, **arrays)  # a file handle: savez adds no ".npz"
    info = {"format": "pdq1", "dtype": dt, "block": bs, "quantized": qnames,
            "bytes_payload": int(b_payload), "bytes_scales": int(b_scales),
            "bytes_wide": int(b_wide)}
    with open(path + QMETA_SUFFIX, "w") as f:
        json.dump(info, f)
    return dict(info)


@torch.no_grad()
def load_quantized(layer, path, deadline_ms=None):
    """Load a :func:`save_quantized` checkpoint into ``layer`` with its
    linear weights narrow: each becomes the payload off the file (on the
    weight's device; ``functional.linear`` routes it through the quantized
    matmul from then on), its scales the non-persistent
    ``weight_q_scale`` buffer. No wide copy of those weights is made.

    Raises ``ValueError`` on an architecture mismatch: quantized names
    with no linear weight here, entries with no state here, and state the
    file leaves uncovered. Returns the meta record with ``load_ms``.
    With ``deadline_ms``, a load that took longer raises ``TimeoutError``
    instead of reporting success (the load itself runs to its end)."""
    t0 = time.perf_counter()
    with open(path + QMETA_SUFFIX) as f:
        meta = json.load(f)
    with np.load(path + QPARAMS_SUFFIX) as z:
        data = {n: z[n] for n in z.files}
    qnames = list(meta["quantized"])
    qmap = {pname: (sub, w)
            for pname, sub, w in qcp.iter_quantizable(layer)}
    missing_q = [n for n in qnames if n not in qmap]
    if missing_q:
        raise ValueError(
            f"quantized checkpoint entries {missing_q} have no matching "
            "linear weight in this layer (architecture mismatch)")
    if meta["dtype"] == "fp8" and qc.fp8_dtype() is None:
        raise NotImplementedError(
            "this checkpoint holds fp8 payloads but this torch has no "
            "float8_e4m3fn; re-save as 'int8'")
    state = {n: torch.from_numpy(a) for n, a in data.items()}
    for pname in qnames:
        sub, w = qmap[pname]
        payload = state[f"{pname}::q"]
        if meta["dtype"] == "fp8":
            payload = payload.view(qc.fp8_dtype())
        qcp.attach_quantized(sub, payload.to(w.device),
                             state[f"{pname}::scale"].to(w.device))
    qset = set(qnames)
    own = layer.state_dict()
    covered, unexpected = [], []
    for name in data:
        if name.split("::", 1)[0] in qset:
            continue
        if name not in own:
            unexpected.append(name)
            continue
        if tuple(state[name].shape) != tuple(own[name].shape):
            raise ValueError(
                f"quantized checkpoint entry {name} has shape "
                f"{tuple(state[name].shape)}, the layer's is "
                f"{tuple(own[name].shape)}")
        own[name].copy_(state[name].to(own[name].dtype))
        covered.append(name)
    left = [n for n in own if n not in covered and n not in qset]
    if unexpected or left:
        raise ValueError(
            "quantized checkpoint does not match this layer: unexpected "
            f"entries {unexpected}, uncovered state {left}")
    info = dict(meta)
    info["load_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
    if deadline_ms is not None and info["load_ms"] > float(deadline_ms):
        raise TimeoutError(
            f"load_quantized({path!r}) took {info['load_ms']}ms, past the "
            f"{float(deadline_ms)}ms deadline: not reporting the load as "
            "delivered")
    return info
