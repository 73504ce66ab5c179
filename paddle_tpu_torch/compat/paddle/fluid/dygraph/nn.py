"""paddle.fluid.dygraph.nn — the 1.x dygraph layer classes (counterpart
of the JAX package's ``paddle/fluid/dygraph/nn.py``).

Reference: python/paddle/fluid/dygraph/nn.py. The 1.x constructors differ
from 2.x in *spelling*, not semantics: `Conv2D(num_channels, num_filters,
filter_size, act=...)` vs `Conv2D(in_channels, out_channels,
kernel_size)`; `Linear(input_dim, output_dim, act=...)`; `Pool2D` as a
layer over the pool functional; `BatchNorm(num_channels, act=...)`. Each
wrapper subclasses the modern layer so parameters, state_dict structure,
and the tape path are identical — only __init__ remaps and `act` fuses.
"""
from __future__ import annotations

import paddle_tpu_torch.nn as _nn
import paddle_tpu_torch.nn.functional as _F


def _act_fn(act):
    if act is None:
        return None
    fn = getattr(_F, act, None)
    if fn is None:
        raise ValueError(f"unknown activation {act!r}")
    return fn


class Linear(_nn.Linear):
    """dygraph/nn.py:971 Linear(input_dim, output_dim, act=None)."""

    def __init__(self, input_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(input_dim, output_dim, weight_attr=param_attr,
                         bias_attr=bias_attr)
        self._act = _act_fn(act)

    def forward(self, x):
        out = super().forward(x)
        return self._act(out) if self._act else out


class Conv2D(_nn.Conv2D):
    """dygraph/nn.py:57 Conv2D(num_channels, num_filters, filter_size)."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None,
                 dtype="float32"):
        super().__init__(num_channels, num_filters, filter_size,
                         stride=stride, padding=padding, dilation=dilation,
                         groups=groups, weight_attr=param_attr,
                         bias_attr=bias_attr)
        self._fluid_act = _act_fn(act)

    def forward(self, x):
        out = super().forward(x)
        return self._fluid_act(out) if self._fluid_act else out


class Pool2D(_nn.Layer):
    """dygraph/nn.py:199 Pool2D — a layer shell over pool2d."""

    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, use_cudnn=True,
                 ceil_mode=False, exclusive=True, data_format="NCHW"):
        super().__init__()
        self._cfg = dict(
            pool_size=pool_size, pool_type=pool_type,
            pool_stride=pool_stride, pool_padding=pool_padding,
            global_pooling=global_pooling, ceil_mode=ceil_mode,
            exclusive=exclusive,
        )

    def forward(self, x):
        from ..layers import pool2d

        return pool2d(x, **self._cfg)


class BatchNorm(_nn.BatchNorm):
    """dygraph/nn.py:1102 — the port's `nn.BatchNorm` already carries the
    fluid signature (num_channels, act=...); only `is_test` needs the
    train/eval-mode translation."""

    def __init__(self, num_channels, act=None, is_test=False, **kw):
        kw.pop("moving_mean_name", None)
        kw.pop("moving_variance_name", None)
        kw.pop("do_model_average_for_mean_and_var", None)
        super().__init__(num_channels, act=act, **kw)
        if is_test:
            self.eval()


class Embedding(_nn.Embedding):
    """dygraph/nn.py:1322 Embedding(size=[vocab, dim])."""

    def __init__(self, size, is_sparse=False, is_distributed=False,
                 padding_idx=None, param_attr=None, dtype="float32"):
        super().__init__(int(size[0]), int(size[1]),
                         padding_idx=padding_idx, sparse=is_sparse,
                         weight_attr=param_attr)


__all__ = ["Linear", "Conv2D", "Pool2D", "BatchNorm", "Embedding"]
