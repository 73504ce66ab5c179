"""paddle.fluid.nets — the composite "net" helpers the book scripts use
(counterpart of the JAX package's ``paddle/fluid/nets.py``).

Reference: python/paddle/fluid/nets.py (simple_img_conv_pool:28,
img_conv_group:100, sequence_conv_pool:229, glu:312,
scaled_dot_product_attention:340). Compositions of fluid.layers calls,
so they work in both modes like the layers they wrap.
"""
from __future__ import annotations

from . import layers

__all__ = [
    "simple_img_conv_pool", "img_conv_group", "sequence_conv_pool", "glu",
    "scaled_dot_product_attention",
]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1,
                         conv_padding=0, conv_dilation=1, conv_groups=1,
                         param_attr=None, bias_attr=None, act=None,
                         use_cudnn=True):
    """nets.py:28 — conv2d + pool2d, the recognize_digits backbone."""
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act,
    )
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling,
    )


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """nets.py:100 — the VGG block: N convs (+BN +dropout) then a pool."""
    tmp = input
    filters = conv_num_filter if isinstance(conv_num_filter, (list, tuple)) \
        else [conv_num_filter]

    def _per(v, i):
        return v[i] if isinstance(v, (list, tuple)) else v

    bns = conv_with_batchnorm if isinstance(conv_with_batchnorm, (list, tuple)) \
        else [conv_with_batchnorm] * len(filters)
    drops = conv_batchnorm_drop_rate \
        if isinstance(conv_batchnorm_drop_rate, (list, tuple)) \
        else [conv_batchnorm_drop_rate] * len(filters)
    for i, nf in enumerate(filters):
        tmp = layers.conv2d(
            input=tmp, num_filters=nf,
            filter_size=_per(conv_filter_size, i),
            padding=_per(conv_padding, i),
            param_attr=_per(param_attr, i),
            act=None if bns[i] else conv_act,
        )
        if bns[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            if drops[i]:
                tmp = layers.dropout(x=tmp, dropout_prob=drops[i])
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, lengths, num_filters, filter_size,
                       param_attr=None, act="sigmoid", pool_type="max",
                       bias_attr=None):
    """nets.py:229 under the dense+lengths LoD policy: the ragged input
    travels as (padded [B, T, D], lengths [B]) and the pool masks by
    lengths (ops/sequence.py sequence_pool)."""
    from paddle_tpu_torch.ops import sequence as _seq
    from paddle_tpu_torch.static.nn import create_parameter

    D = int(input.shape[-1])
    w = create_parameter(
        [int(filter_size) * D, int(num_filters)], "float32",
        attr=param_attr,
    )
    conv = _seq.sequence_conv(input, w, lengths, int(filter_size))
    if act:
        import paddle_tpu_torch.nn.functional as F

        conv = getattr(F, act)(conv)
    return _seq.sequence_pool(conv, pool_type, lengths)


def glu(input, dim=-1):
    """nets.py:312 gated linear unit."""
    import paddle_tpu_torch.nn.functional as F

    return F.glu(input, axis=dim)


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """nets.py:340: multi-head attention over dense [B, T, D] operands."""
    import paddle_tpu_torch as _P
    import paddle_tpu_torch.nn.functional as F

    B, Tq, D = queries.shape
    Tk = keys.shape[1]
    dh = D // num_heads

    def split_heads(x, T):
        return _P.transpose(
            _P.reshape(x, [B, T, num_heads, dh]), [0, 2, 1, 3]
        )

    q = split_heads(queries, Tq)
    k = split_heads(keys, Tk)
    v = split_heads(values, Tk)
    scores = _P.matmul(q, k, transpose_y=True) * (dh ** -0.5)
    attn = F.softmax(scores, axis=-1)
    if dropout_rate:
        attn = F.dropout(attn, p=dropout_rate)
    ctx = _P.matmul(attn, v)
    return _P.reshape(_P.transpose(ctx, [0, 2, 1, 3]), [B, Tq, D])
