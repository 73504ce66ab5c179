"""paddle.summary and paddle.flops (counterpart of
``paddle_tpu/hapi/summary.py``; reference: python/paddle/hapi/
model_summary.py, dynamic_flops.py): a per-layer table from forward hooks
on the leaf layers over a zero input on the current device, and the
parameter totals."""
from __future__ import annotations

from typing import List

import numpy as np

import torch

from ..core.tensor import Tensor
from ..nn.layer import Layer

__all__ = ["summary", "flops"]


def _shapes(out):
    if isinstance(out, (Tensor, torch.Tensor)):
        return list(out.shape)
    if isinstance(out, (list, tuple)):
        return [_shapes(o) for o in out]
    return []


def _canon_input_sizes(input_size):
    """int-sequence | shape tuple | sequence of shape tuples -> list of
    shape tuples (shared by summary and flops)."""
    seq = list(input_size)
    if seq and isinstance(seq[0], (tuple, list)):
        return [tuple(s) for s in seq]
    return [tuple(seq)]


def _build_dummy_inputs(input_sizes, dtypes):
    dtypes = dtypes or ["float32"] * len(input_sizes)
    if isinstance(dtypes, str):
        dtypes = [dtypes] * len(input_sizes)
    return [
        Tensor(np.zeros(
            tuple(1 if d == -1 else d for d in shape), dt
        ))
        for shape, dt in zip(input_sizes, dtypes)
    ]


def _run_with_leaf_hooks(net, input_sizes, dtypes, make_hook):
    """Register `make_hook()` on every leaf sublayer, run a dummy eval
    forward, restore mode, always remove hooks."""
    hooks = [
        sub.register_forward_post_hook(make_hook())
        for _, sub in net.named_sublayers() if not sub.sublayers()
    ]
    was_training = net.training
    net.eval()
    try:
        net(*_build_dummy_inputs(input_sizes, dtypes))
    finally:
        for h in hooks:
            h.remove()
        if was_training:
            net.train()


def summary(net: Layer, input_size, dtypes=None):
    """Print a layer table; returns {'total_params', 'trainable_params'}.

    `input_size`: a shape tuple, or list of shape tuples for multi-input
    forwards. A -1 leading dim means batch (replaced by 1)."""
    rows: List[tuple] = []

    def make_hook():
        def hook(lyr, inputs, output=None):
            n_params = sum(
                int(np.prod(p.shape)) for p in lyr.parameters(
                    include_sublayers=False
                )
            )
            rows.append(
                (f"{type(lyr).__name__}-{len(rows) + 1}",
                 _shapes(output), n_params)
            )
        return hook

    _run_with_leaf_hooks(net, _canon_input_sizes(input_size), dtypes,
                         make_hook)

    total = sum(int(np.prod(p.shape)) for p in net.parameters())
    trainable = sum(
        int(np.prod(p.shape)) for p in net.parameters() if p.trainable
    )
    name_w = max([len(r[0]) for r in rows] + [12]) + 2
    print("-" * (name_w + 40))
    print(f"{'Layer (type)':<{name_w}}{'Output Shape':<24}{'Param #':>10}")
    print("=" * (name_w + 40))
    for name, shape, n in rows:
        print(f"{name:<{name_w}}{str(shape):<24}{n:>10,}")
    print("=" * (name_w + 40))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    print(f"Non-trainable params: {total - trainable:,}")
    print("-" * (name_w + 40))
    return {"total_params": total, "trainable_params": trainable}


def flops(net: Layer, input_size, custom_ops=None, print_detail=False,
          dtypes=None):
    """paddle.flops (reference: hapi/dynamic_flops.py): per-layer FLOP
    accounting via forward hooks. Counts multiply-accumulates for
    conv/linear (the reference's convention) and elementwise costs for
    norm/activation/pool; `custom_ops` maps Layer type -> fn(layer,
    input_shape, output_shape) -> flops. `dtypes` matches summary's (int
    dtypes let embedding-first models be measured)."""
    custom_ops = custom_ops or {}
    rows = []

    def count(lyr, inputs, output):
        in_shape = list(inputs[0].shape) if inputs else []
        out_shape = _shapes(output)
        n_out = int(np.prod(out_shape)) if out_shape and isinstance(
            out_shape[0], int
        ) else 0
        cls = type(lyr)
        if cls in custom_ops:
            f = custom_ops[cls](lyr, in_shape, out_shape)
        elif hasattr(lyr, "_kernel_size") or cls.__name__.startswith("Conv"):
            k = getattr(lyr, "_kernel_size", getattr(lyr, "kernel_size", [1]))
            k = k if isinstance(k, (list, tuple)) else [k]
            cin = getattr(lyr, "_in_channels", in_shape[1] if len(in_shape) > 1 else 1)
            groups = getattr(lyr, "_groups", 1) or 1
            f = n_out * int(np.prod(k)) * cin // groups
        elif cls.__name__ == "Linear":
            f = n_out * lyr.weight.shape[0]
        elif cls.__name__ in ("BatchNorm2D", "BatchNorm1D", "BatchNorm",
                              "LayerNorm", "GroupNorm"):
            f = 2 * n_out
        elif cls.__name__.endswith("Pool2D") or cls.__name__ in (
            "ReLU", "GELU", "Sigmoid", "Tanh", "Softmax", "Dropout",
        ):
            f = n_out
        else:
            f = 0
        rows.append((f"{cls.__name__}-{len(rows) + 1}", out_shape, f))

    def make_hook():
        def hook(lyr, inputs, output=None):
            count(lyr, inputs, output)
        return hook

    _run_with_leaf_hooks(net, _canon_input_sizes(input_size), dtypes,
                         make_hook)

    total = sum(r[2] for r in rows)
    if print_detail:
        for name, shape, f in rows:
            print(f"{name:<24}{str(shape):<24}{f:>14,}")
    print(f"Total Flops: {total}     Total Params: "
          f"{sum(int(np.prod(p.shape)) for p in net.parameters()):,}")
    return total
