"""Whole-model artifacts and quantized weight checkpoints (counterpart of
``paddle_tpu/jit/save_load.py``): ``save`` / ``load`` / ``TranslatedLayer``
and ``save_quantized`` / ``load_quantized``.

``save`` / ``load`` (reference: python/paddle/fluid/dygraph/jit.py save
:507, load :787; fluid/dygraph/io.py TranslatedLayer) persist a Layer's
forward as a program plus its weights, loadable without the model's
source. The JAX package's artifact is serialized StableHLO, which torch
cannot read; the port writes its own, a named departure, and parity with
the JAX package is on outputs, not bytes:

- ``path + ".pdmodel"``: ``torch.export.save`` of the ``to_static``
  capture (``jit/program.py``) at the input specs, every parameter and
  buffer lifted to an input; the kernels appear as the custom ops of
  ``ops/kernels``, so loading needs only ``import paddle_tpu_torch``;
- ``path + ".pdiparams"``: ``torch.save`` of the parameters and buffers
  in the capture's input order, on the CPU;
- ``path + ".pdmeta"``: JSON: the format tag, the input specs (a ``None``
  dim is captured at 1, as in the JAX package), the counts of parameters,
  buffers and outputs, the output structure, the device it was captured
  on.

Devices: a ``TranslatedLayer`` runs on the ``set_device`` default (the
card) unless the caller passes ``device`` (``"cpu"``); an artifact captured
on one device loads on another through ``torch.export``'s
``move_to_device_pass``, which rewrites the devices the program names.

The quantized checkpoint's file format is the JAX package's own, so a
checkpoint written by either package loads into the other:
``path + ".pdqparams"``, an npz of ``name::q`` (int8 payload, or the fp8
payload's bytes as uint8) and ``name::scale`` (float32 scales) for every
linear weight in paddle's ``[in, out]`` layout (the port's own), plain
``name`` entries for the wide rest (embeddings, norms, biases, persistent
buffers); and ``path + ".pdqmeta"``, a JSON record ``{"format": "pdq1",
"dtype", "block", "quantized": [names], "bytes_payload", "bytes_scales",
"bytes_wide"}``. The arrays cross as they are, an fp8 payload as its
uint8 bytes.

Not ported yet: the ``q_checkpoint`` bus record (item 8).
"""
from __future__ import annotations

import json
import os
import pickle
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import convert_dtype
from ..core.tensor import Parameter, Tensor
from ..distributed import quantized_comm as qc
from ..distributed import quantized_compute as qcp
from ..nn.layer import Layer
from .program import (InputSpec, StaticFunction, _CapturedProgram,
                      _collect_layers, _unflatten_out)

__all__ = ["MODEL_SUFFIX", "PARAMS_SUFFIX", "META_SUFFIX", "QPARAMS_SUFFIX",
           "QMETA_SUFFIX", "save", "load", "TranslatedLayer",
           "save_quantized", "load_quantized"]

MODEL_SUFFIX = ".pdmodel"
PARAMS_SUFFIX = ".pdiparams"
META_SUFFIX = ".pdmeta"
#: the artifact format's tag (``.pdmeta``)
FORMAT = "ptt-export-1"
QPARAMS_SUFFIX = ".pdqparams"
QMETA_SUFFIX = ".pdqmeta"
#: the key suffixes of a linear weight's quantized pair
Q_SUFFIXES = ("::q", "::scale")


def _makedirs(path):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)


def save(layer, path, input_spec=None, **configs):
    """paddle.jit.save(layer, path, input_spec=[InputSpec(...)]): capture
    ``layer``'s forward (a Layer, or a ``to_static`` function) at the
    specs, in its CURRENT mode (as in the reference: switch to ``eval()``
    first to save for inference), and write the three files of the module
    docstring. Returns the meta record."""
    if isinstance(layer, StaticFunction):
        fn, owner = layer._fn, layer._layer
        layers = _collect_layers(owner, fn)
    elif isinstance(layer, Layer):
        fn = layer.forward
        fn = fn._fn if isinstance(fn, StaticFunction) else fn
        layers = [layer]
    else:
        raise TypeError("jit.save expects a Layer or a to_static function")
    if input_spec is None:
        raise ValueError(
            "jit.save requires input_spec=[InputSpec(shape, dtype), ...] "
            "(the program is captured at concrete shapes)")
    specs = [s if isinstance(s, InputSpec) else InputSpec.from_tensor(s)
             for s in input_spec]
    prog = _CapturedProgram(fn, layers, {},
                            tuple(("tensor", None) for _ in specs),
                            getattr(fn, "__name__", "forward"))
    live = prog.state.live()
    device = live[0].device if live else resolve_device(None)
    examples = [Tensor._wrap(torch.zeros(
        tuple(1 if d is None else int(d) for d in s.shape),
        dtype=convert_dtype(s.dtype), device=device)) for s in specs]
    prog.capture(examples)
    if prog.rebound:
        raise NotImplementedError(
            "jit.save: the forward rebinds buffers; save it in eval()")
    _makedirs(path)
    with open(path + MODEL_SUFFIX, "wb") as f:
        torch.export.save(prog.exported, f)
    torch.save({"params": [p.detach().cpu() for p in prog.params],
                "buffers": [b.detach().cpu() for b in prog.buffers]},
               path + PARAMS_SUFFIX)
    meta = {"format": FORMAT,
            "input_specs": [[list(s.shape), str(s.dtype)] for s in specs],
            "n_params": len(prog.params), "n_buffers": len(prog.buffers),
            "n_outputs": prog.n_out,
            "out_treedef": pickle.dumps(prog.out_treedef).hex(),
            "device": str(device)}
    with open(path + META_SUFFIX, "w") as f:
        json.dump(meta, f)
    return meta


class TranslatedLayer(Layer):
    """The executable loaded artifact (reference: fluid/dygraph/io.py
    TranslatedLayer): runs the captured program on its own parameters
    (``param_<i>``, trainable) and buffers (``buffer_<i>``) on
    ``device``."""

    def __init__(self, program, params, buffers, meta, device):
        super().__init__()
        self._program = program
        self._meta = meta
        self._out_treedef = pickle.loads(bytes.fromhex(meta["out_treedef"]))
        self._device = device
        for i, p in enumerate(params):
            self.add_parameter(f"param_{i}", Parameter(
                p.to(device), requires_grad=p.is_floating_point()))
        for i, b in enumerate(buffers):
            self.register_buffer(f"buffer_{i}", b.to(device))

    def forward(self, *inputs):
        raws = [x._data if isinstance(x, Tensor) else x if isinstance(
            x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            for x in inputs]
        raws = [r.to(self._device) for r in raws]
        outs = self._program(*self.parameters(), *self.buffers(), *raws)
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        # torch tensors in (a torch caller, or a Tensor caller through the
        # Layer boundary, which wraps the results), torch tensors out
        out = _unflatten_out(list(outs)[:self._meta["n_outputs"]],
                             self._out_treedef, wrap=not any(
                                 isinstance(x, torch.Tensor) for x in inputs))
        if isinstance(out, (list, tuple)) and len(out) == 1:
            return out[0]
        return out


def load(path, device=None, **configs) -> TranslatedLayer:
    """paddle.jit.load(path) -> :class:`TranslatedLayer` on ``device``
    (the ``set_device`` default when None)."""
    from torch.export.passes import move_to_device_pass

    with open(path + META_SUFFIX) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"jit.load: {path}{META_SUFFIX} is not an artifact "
                         f"of this package (format {meta.get('format')!r})")
    # "meta" computes shapes only (no data): a program to inspect
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    with open(path + MODEL_SUFFIX, "rb") as f:
        ep = torch.export.load(f)
    if torch.device(meta["device"]) != dev:
        ep = move_to_device_pass(ep, dev)
    state = torch.load(path + PARAMS_SUFFIX, map_location="cpu")
    return TranslatedLayer(ep.module(), state["params"], state["buffers"],
                           meta, dev)


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
