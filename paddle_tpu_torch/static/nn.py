"""paddle.static.nn — fluid-style layer BUILDERS for static-graph scripts
(counterpart of ``paddle_tpu/static/nn.py``).

Reference: python/paddle/static/nn/__init__.py re-exporting
fluid/layers/nn.py builders (fc :87, conv2d :1402, batch_norm :2634,
embedding, layer_norm, ...). Each call constructs fresh parameters (via
the corresponding ``nn`` Layer of the port) and applies them to the
symbolic input: the layer's call is recorded as one op with its
parameters beside it, so they become leaves of the Program exactly like
LayerHelper.create_parameter's variables enter the reference's Program.
In eager mode the same builders run the layers at once.

Channel/feature counts are inferred from the symbolic input's shape, so
reference scripts port with only the import changed.
"""
from __future__ import annotations

import numpy as np

from ..nn.layer import Layer
from ..jit.control_flow import case, cond, switch_case, while_loop  # noqa: F401

__all__ = [
    "fc", "batch_norm", "embedding", "conv2d", "conv2d_transpose",
    "conv3d", "create_parameter", "layer_norm", "group_norm",
    "instance_norm", "prelu", "deform_conv2d",
    "cond", "case", "switch_case", "while_loop",
]


def _shape_of(x) -> tuple:
    from .program import static_var

    var = static_var(x)
    if var is not None:
        return tuple(var.shape)
    return tuple(x.shape)


def _dim(x, axis, what):
    s = _shape_of(x)
    d = s[axis]
    if d is None or (isinstance(d, int) and d < 0):
        raise ValueError(
            f"{what}: input dim {axis} must be static to size the "
            f"parameters, got shape {s}"
        )
    return int(d)


def _act(out, act):
    if act is None:
        return out
    from ..nn import functional as F

    fn = getattr(F, act, None)
    if fn is None:
        raise ValueError(f"unknown activation {act!r}")
    return fn(out)


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """fluid.layers.fc (fluid/layers/nn.py:87): flatten trailing dims,
    one linear per input (single-input form), optional activation."""
    from .. import ops
    from ..nn import Linear

    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = []
    for xi in xs:
        shape = _shape_of(xi)
        in_features = int(np.prod([
            _dim(xi, a, "fc") for a in range(num_flatten_dims, len(shape))
        ]))
        lin = Linear(in_features, size, weight_attr=weight_attr,
                     bias_attr=bias_attr)
        flat = xi if len(shape) == num_flatten_dims + 1 else ops.reshape(
            xi, [0] * num_flatten_dims + [in_features]
            if num_flatten_dims > 1 else [-1, in_features]
        )
        outs.append(lin(flat))
    out = outs[0]
    for o in outs[1:]:
        out = out + o
    return _act(out, activation)


def conv2d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None, data_format="NCHW"):
    """fluid.layers.conv2d (nn.py:1402)."""
    from ..nn import Conv2D

    cin = _dim(input, 1 if data_format == "NCHW" else 3, "conv2d")
    conv = Conv2D(cin, num_filters, filter_size, stride=stride,
                  padding=padding, dilation=dilation, groups=groups,
                  weight_attr=param_attr, bias_attr=bias_attr,
                  data_format=data_format)
    return _act(conv(input), act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None, data_format="NCHW"):
    from ..nn import Conv2DTranspose

    cin = _dim(input, 1 if data_format == "NCHW" else 3,
               "conv2d_transpose")
    conv = Conv2DTranspose(cin, num_filters, filter_size, stride=stride,
                           padding=padding, dilation=dilation,
                           groups=groups, weight_attr=param_attr,
                           bias_attr=bias_attr, data_format=data_format)
    return _act(conv(input), act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0,
           dilation=1, groups=1, param_attr=None, bias_attr=None,
           use_cudnn=True, act=None, name=None, data_format="NCDHW"):
    from ..nn import Conv3D

    cin = _dim(input, 1 if data_format == "NCDHW" else 4, "conv3d")
    conv = Conv3D(cin, num_filters, filter_size, stride=stride,
                  padding=padding, dilation=dilation, groups=groups,
                  weight_attr=param_attr, bias_attr=bias_attr,
                  data_format=data_format)
    return _act(conv(input), act)


def batch_norm(input, act=None, is_test=False, momentum=0.9,
               epsilon=1e-5, param_attr=None, bias_attr=None,
               data_layout="NCHW", name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    """fluid.layers.batch_norm (nn.py:2634). is_test selects inference
    stats (the recorded op uses batch stats otherwise, refreshing the
    layer's running buffers through the program's buffer threading)."""
    from ..nn.layers.norm import BatchNorm

    ch = _dim(input, 1 if data_layout == "NCHW" else -1, "batch_norm")
    bn = BatchNorm(ch, momentum=momentum, epsilon=epsilon,
                   param_attr=param_attr, bias_attr=bias_attr,
                   data_layout=data_layout,
                   use_global_stats=use_global_stats)
    if is_test:
        bn.eval()
    return _act(bn(input), act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """fluid.layers.embedding: size = [vocab, dim]."""
    from ..nn import Embedding

    emb = Embedding(int(size[0]), int(size[1]), padding_idx=padding_idx,
                    weight_attr=param_attr)
    return emb(input)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    from ..nn import LayerNorm

    shape = _shape_of(input)
    normalized = [
        _dim(input, a, "layer_norm") for a in range(begin_norm_axis,
                                                    len(shape))
    ]
    ln = LayerNorm(normalized, epsilon=epsilon, weight_attr=param_attr,
                   bias_attr=bias_attr)
    return _act(ln(input), act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None,
               bias_attr=None, act=None, data_layout="NCHW", name=None):
    from ..nn import GroupNorm

    ch = _dim(input, 1 if data_layout == "NCHW" else -1, "group_norm")
    gn = GroupNorm(groups, ch, epsilon=epsilon, weight_attr=param_attr,
                   bias_attr=bias_attr, data_format=data_layout)
    return _act(gn(input), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    from ..nn import InstanceNorm2D

    ch = _dim(input, 1, "instance_norm")
    inorm = InstanceNorm2D(ch, epsilon=epsilon, weight_attr=param_attr,
                           bias_attr=bias_attr)
    return inorm(input)


def prelu(x, mode="all", param_attr=None, name=None):
    from ..nn import PReLU

    if mode == "all":
        num = 1
    elif mode == "channel":
        num = _dim(x, 1, "prelu")
    else:
        raise ValueError("prelu mode must be 'all' or 'channel'")
    return PReLU(num_parameters=num, weight_attr=param_attr)(x)


def deform_conv2d(x, offset, mask, num_filters, filter_size, stride=1,
                  padding=0, dilation=1, groups=1, deformable_groups=1,
                  im2col_step=1, param_attr=None, bias_attr=None,
                  name=None):
    from ..vision.ops import DeformConv2D

    cin = _dim(x, 1, "deform_conv2d")
    conv = DeformConv2D(cin, num_filters, filter_size, stride=stride,
                        padding=padding, dilation=dilation,
                        deformable_groups=deformable_groups,
                        groups=groups, weight_attr=param_attr,
                        bias_attr=bias_attr)
    return conv(x, offset, mask=mask)


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """fluid.layers.create_parameter via the Layer-free path."""
    holder = Layer()
    return holder.create_parameter(
        shape=list(shape), attr=attr, dtype=dtype, is_bias=is_bias,
        default_initializer=default_initializer,
    )
