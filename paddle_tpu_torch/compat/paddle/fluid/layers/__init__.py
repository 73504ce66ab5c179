"""paddle.fluid.layers — the 1.x flat layer/op namespace (counterpart of
the JAX package's ``paddle/fluid/layers/__init__.py``).

Reference: python/paddle/fluid/layers/ (nn.py, tensor.py, ops.py,
control_flow.py, sequence ops). Fluid put *everything* in one flat
module; this alias rebuilds it from three modern facades — the flat op
namespace (the port's `ops`, the LoD sequence ops included), the
functional layer namespace (`nn.functional`), and the graph-building
layer factories (`static.nn`) — then layers the fluid-only spellings on top:
`data` (append_batch_size), `reduce_*` (dim/keep_dim), `cross_entropy`
over *probabilities* (1.x took post-softmax inputs; the 2.x spelling
takes logits), `dropout(dropout_prob=)`, `pool2d`, op-based `accuracy`.

Graph-building entry points engage static mode implicitly — a fluid
script never calls enable_static (see ../framework.py).
"""
from __future__ import annotations

import numpy as np

# bulk surfaces first; fluid-specific wrappers below override name-by-name
from paddle_tpu_torch.ops import *  # noqa: F401,F403
from paddle_tpu_torch.nn.functional import *  # noqa: F401,F403
from paddle_tpu_torch.static.nn import *  # noqa: F401,F403

import paddle_tpu_torch as _P
import paddle_tpu_torch.nn.functional as _F
import paddle_tpu_torch.static as _static
import paddle_tpu_torch.static.nn as _snn
from paddle_tpu_torch.ops import sequence as _seq  # noqa: F401
from paddle_tpu_torch.core.tensor import Tensor as _Tensor

from ..framework import _ensure_static


def data(name, shape, dtype="float32", append_batch_size=True,
         lod_level=0, type=None, stop_gradient=True):
    """fluid.layers.data (layers/io.py:54): unlike fluid.data, the 1.x
    spelling prepends a -1 batch dim unless the shape already carries
    one."""
    _ensure_static()
    shape = list(shape)
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    return _static.data(name, shape, dtype)


def fc(input=None, size=None, num_flatten_dims=1, param_attr=None,
       bias_attr=None, act=None, is_test=False, name=None, **kw):
    """fluid.layers.fc (nn.py:87): the 1.x keyword spellings (`input=`,
    `param_attr=`, `act=`) over static.nn.fc (`x=`, `weight_attr=`,
    `activation=`)."""
    if input is None:
        input = kw.pop("x")
    return _snn.fc(input, size, num_flatten_dims=num_flatten_dims,
                   weight_attr=kw.pop("weight_attr", param_attr),
                   bias_attr=bias_attr,
                   activation=kw.pop("activation", act), name=name)


# ---- reduce_* family (1.x dim/keep_dim spellings) -----------------------

def _reduce(fn, input, dim=None, keep_dim=False, name=None):
    axis = dim if dim is None or isinstance(dim, (list, tuple)) \
        else [dim]
    return fn(input, axis=axis, keepdim=keep_dim)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce(_P.mean, input, dim, keep_dim)


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce(_P.sum, input, dim, keep_dim)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce(_P.max, input, dim, keep_dim)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce(_P.min, input, dim, keep_dim)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce(_P.prod, input, dim, keep_dim)


# ---- elementwise_* family ----------------------------------------------

def _ew(op):
    def f(x, y, axis=-1, act=None, name=None):
        # fluid axis-aligned broadcasting (elementwise_op_function.h):
        # y's dims align with x starting at `axis` (default -1 = align
        # trailing, i.e. axis = x.ndim - y.ndim) — e.g. x [N,C,H,W] +
        # y [C] with axis=1 is a per-channel add. Numpy broadcasting
        # alone would align y against the TRAILING dims instead.
        xnd = len(x.shape)
        ynd = len(y.shape)
        ax = axis if axis >= 0 else xnd - ynd
        if 0 <= ax and ax + ynd <= xnd and (ax != xnd - ynd):
            y = _P.reshape(
                y, list(y.shape) + [1] * (xnd - ax - ynd)
            )
        out = op(x, y)
        return _snn._act(out, act)

    return f


elementwise_add = _ew(lambda x, y: x + y)
elementwise_sub = _ew(lambda x, y: x - y)
elementwise_mul = _ew(lambda x, y: x * y)
elementwise_div = _ew(lambda x, y: x / y)
elementwise_max = _ew(_P.maximum)
elementwise_min = _ew(_P.minimum)
elementwise_pow = _ew(_P.pow)


# ---- losses / metrics ---------------------------------------------------

def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  name=None):
    """fluid.layers.cross_entropy (layers/loss.py:231): `input` is a
    PROBABILITY distribution (post-softmax — the 1.x idiom is
    fc(act='softmax') feeding this), returns the per-row -log p[label]
    with shape [N, 1]. The 2.x `F.cross_entropy` takes logits and
    reduces; mapping this name onto it would double-softmax every 1.x
    script."""
    C = input.shape[-1]
    p = _P.clip(input, 1e-10, 1.0)
    if soft_label:
        out = -_P.sum(label * _P.log(p), axis=-1, keepdim=True)
    else:
        lbl = label
        if len(lbl.shape) == len(input.shape):
            lbl = _P.squeeze(lbl, axis=-1)
        oh = _F.one_hot(lbl, C).astype(input.dtype)
        out = -_P.sum(oh * _P.log(p), axis=-1, keepdim=True)
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """layers/loss.py:1097: fused logits version, per-row [N, 1] loss."""
    loss = _F.cross_entropy(
        logits, label if soft_label or len(label.shape) < len(logits.shape)
        else _P.squeeze(label, axis=-1),
        soft_label=soft_label, reduction="none", axis=axis,
        ignore_index=ignore_index,
    )
    loss = _P.unsqueeze(loss, axis=-1)
    if return_softmax:
        return loss, _F.softmax(logits, axis=axis)
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      name=None, normalize=False):
    """layers/loss.py sigmoid_cross_entropy_with_logits: per-element BCE
    with positions where label == ignore_index zeroed; normalize=True
    divides by the count of non-ignored elements."""
    out = _F.binary_cross_entropy_with_logits(
        x, _P.cast(label, x.dtype if hasattr(x, "dtype") else "float32"),
        reduction="none",
    )
    keep = _P.cast(_P.logical_not(_P.equal(label, ignore_index)), out.dtype)
    out = out * keep
    if normalize:
        out = out / _P.clip(_P.sum(keep), 1.0, None)
    return out


def accuracy(input, label, k=1, correct=None, total=None):
    """layers/metric_op.py:34 as a graph op (the `metric` version is
    numpy-eager and cannot record into a static Program):
    top-k membership, scalar mean."""
    if len(label.shape) == 1:
        label = _P.unsqueeze(label, axis=-1)
    _, topk_idx = _P.topk(input, k=k, axis=-1)
    hit = _P.equal(topk_idx, label.astype(topk_idx.dtype))
    hit = _P.cast(_P.any(hit, axis=-1), "float32")
    return _P.mean(hit)


# ---- shape / dtype / filling -------------------------------------------

def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    return _P.full(shape, value, dtype=dtype)


def shape(input):
    """layers/nn.py shape: the known shape as an int32 tensor."""
    return _P.to_tensor(np.asarray(tuple(input.shape), np.int32))


def one_hot(input, depth, allow_out_of_range=False):
    x = input
    if len(x.shape) > 1 and x.shape[-1] == 1:
        x = _P.squeeze(x, axis=-1)
    return _F.one_hot(x, depth)


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    """layers/nn.py mul: flattening matmul (the 1.x fc backbone)."""
    xs, ys = x, y
    if len(x.shape) > x_num_col_dims + 1:
        d = int(np.prod(x.shape[x_num_col_dims:]))
        xs = _P.reshape(x, [-1, d])
    if len(y.shape) > 2:
        d = int(np.prod(y.shape[:y_num_col_dims]))
        ys = _P.reshape(y, [d, -1])
    return _P.matmul(xs, ys)


def dropout(x, dropout_prob=0.5, is_test=False, seed=None,
            name=None, dropout_implementation="downgrade_in_infer"):
    mode = ("downscale_in_infer"
            if dropout_implementation == "downgrade_in_infer"
            else "upscale_in_train")
    return _F.dropout(x, p=dropout_prob, training=not is_test, mode=mode)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, name=None, exclusive=True,
           data_format="NCHW"):
    """fluid.layers.pool2d (nn.py:2128) onto the 2.x pool functionals."""
    if global_pooling:
        return _F.adaptive_avg_pool2d(input, 1) if pool_type == "avg" \
            else _F.adaptive_max_pool2d(input, 1)
    if pool_type == "avg":
        return _F.avg_pool2d(input, pool_size, stride=pool_stride,
                             padding=pool_padding, ceil_mode=ceil_mode,
                             exclusive=exclusive)
    return _F.max_pool2d(input, pool_size, stride=pool_stride,
                         padding=pool_padding, ceil_mode=ceil_mode)


# 1.x axes-plural spellings
def squeeze(input, axes=None, name=None):
    return _P.squeeze(input, axis=axes)


def unsqueeze(input, axes, name=None):
    axes = axes if isinstance(axes, (list, tuple)) else [axes]
    out = input
    for a in axes:
        out = _P.unsqueeze(out, axis=a)
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   name=None):
    return _P.uniform(shape, dtype=dtype, min=min, max=max)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32",
                    name=None):
    return _P.normal(mean=mean, std=std, shape=shape).astype(dtype)


def assign(input, output=None):
    out = _P.assign(input) if output is None else _P.assign(input, output)
    return out


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """layers/control_flow.py Print: debug identity. Eager mode prints
    immediately; under a static trace values are symbolic, so the op is
    identity (the recorded program prints nothing)."""
    if isinstance(input, _Tensor) and not _static._static_mode_on():
        arr = input.numpy()
        # reference semantics: summarize=-1 prints EVERYTHING
        print(message or "", arr[:summarize] if summarize > 0 else arr)
    return input


# fluid embedding: [N, 1] int ids were the LoD idiom; squeeze them
def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    x = input
    if len(x.shape) > 1 and x.shape[-1] == 1:
        x = _P.squeeze(x, axis=-1)
    return _snn.embedding(x, size, is_sparse=is_sparse,
                          padding_idx=padding_idx, param_attr=param_attr,
                          dtype=dtype)
