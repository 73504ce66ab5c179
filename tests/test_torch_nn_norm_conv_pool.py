"""The port's normalization, convolution and pooling functionals and layers
against paddle_tpu's, with the helpers of ``test_torch_nn_activation.py``:
outputs and gradients within 1e-5 of their largest value (sums in
different orders and libraries).

Named departures, held against a plain computation instead: ``return_mask``
on the max pools (the index of each maximum, flat within its input
plane), "SAME"/"VALID" pool padding, and a convolution's ``padding_mode``
other than "zeros" (the JAX package raises on all three or ignores the
mask).
"""
import numpy as np
import pytest

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF

import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from test_torch_nn_activation import carry, compare, compare_layers
from test_torch_ops_math import arr, cpu_device  # noqa: F401

REL = 1e-5
X3 = arr((2, 4, 9), seed=11)
X4 = arr((2, 4, 7, 6), seed=2)
X5 = arr((1, 4, 5, 6, 4), seed=3)


def last(x):
    return np.moveaxis(x, 1, -1).copy()


def both(name, args, kw=None, grad=True):
    """``name`` of both packages on ``args``; numpy keyword arguments go
    in as each package's tensors."""
    def kws(pkg):
        return {k: pkg.to_tensor(v) if isinstance(v, np.ndarray) else v
                for k, v in (kw or {}).items()}

    compare(lambda *a: getattr(JF, name)(*a, **kws(paddle_tpu)),
            lambda *a: getattr(TF, name)(*a, **kws(pt)), args, grad=grad,
            rel=REL)


W6 = arr((4,), 0.5, 1.5, seed=4)
B6 = arr((4,), seed=5)
NORMS = [
    ("group_norm", (X4, 2), dict(epsilon=1e-4)),
    ("group_norm", (last(X4), 4), dict(data_format="NHWC")),
    ("instance_norm", (X4,), {}), ("instance_norm", (last(X5),),
                                   dict(data_format="NDHWC")),
    ("normalize", (X4,), {}), ("normalize", (X3,), dict(p=1, axis=-1)),
    ("local_response_norm", (X4, 3), {}),
    ("local_response_norm", (last(X4), 4), dict(data_format="NHWC",
                                                alpha=1e-2, k=2.0)),
]


def test_norm_functionals():
    for name, args, kw in NORMS:
        both(name, args, kw)


def test_affine_norms_and_their_layers():
    both("group_norm", (X4, 2, 1e-5, W6, B6))
    both("instance_norm", (X4,), dict(weight=W6, bias=B6))
    for jl, tl, x in (
            (jnn.GroupNorm(2, 4), tnn.GroupNorm(2, 4), X4),
            (jnn.InstanceNorm1D(4), tnn.InstanceNorm1D(4), X3),
            (jnn.InstanceNorm2D(4), tnn.InstanceNorm2D(4), X4),
            (jnn.InstanceNorm3D(4), tnn.InstanceNorm3D(4), X5),
            (jnn.LocalResponseNorm(3), tnn.LocalResponseNorm(3), X4)):
        for p in jl.parameters():
            p.set_value(arr(tuple(p.shape), 0.5, 1.5, seed=6))
        compare_layers(jl, tl, (x,), rel=REL)


def test_batch_norms_train_and_eval():
    """``BatchNorm1D/2D/3D``, fluid ``BatchNorm(act=)`` and
    ``SyncBatchNorm``: the output and gradients in training, the running
    statistics after it (momentum 0.9, Paddle's convention), then eval."""
    for jl, tl, x in (
            (jnn.BatchNorm1D(4), tnn.BatchNorm1D(4), X3),
            (jnn.BatchNorm2D(4, momentum=0.8), tnn.BatchNorm2D(
                4, momentum=0.8), X4),
            (jnn.BatchNorm3D(4), tnn.BatchNorm3D(4), X5),
            (jnn.BatchNorm(4, act="relu"), tnn.BatchNorm(4, act="relu"), X4),
            (jnn.BatchNorm(4, act="sigmoid"), tnn.BatchNorm(
                4, act="sigmoid"), X4),
            (jnn.SyncBatchNorm(4), tnn.SyncBatchNorm(4), X4)):
        compare_layers(jl, tl, (x,), rel=REL)
        for name in ("_mean", "_variance"):
            np.testing.assert_allclose(
                getattr(tl, name).cpu().numpy(),
                np.asarray(getattr(jl, name)._data), rtol=1e-5, atol=1e-6)
        jl.eval()
        tl.eval()
        compare(jl, tl, (x,), rel=REL, grad=False)
    seq = tnn.Sequential(tnn.Conv2D(4, 4, 1), tnn.BatchNorm2D(4))
    assert tnn.SyncBatchNorm.convert_sync_batchnorm(seq) is seq
    assert type(seq[1]) is tnn.SyncBatchNorm
    for pkg in (jnn, tnn):
        with pytest.raises(NotImplementedError):
            pkg.SpectralNorm([4, 3])


# (functional, x, weight shape, kwargs)
CONVS = [
    ("conv1d", X3, (6, 4, 3), dict(stride=2, padding=1)),
    ("conv1d", last(X3), (4, 2, 2), dict(padding="SAME", groups=2,
                                         dilation=2, data_format="NLC")),
    ("conv2d", last(X4), (5, 4, 3, 2), dict(padding="SAME", stride=2,
                                            data_format="NHWC")),
    ("conv2d", X4, (6, 2, 3, 3), dict(padding=[1, 0, 2, 1], groups=2)),
    ("conv3d", X5, (3, 4, 2, 3, 2), dict(padding=1, stride=[1, 2, 1])),
    ("conv3d", last(X5), (3, 4, 3, 3, 3), dict(padding="VALID",
                                               data_format="NDHWC")),
    ("conv1d_transpose", X3, (4, 3, 3), dict(stride=2, padding=1,
                                             output_padding=1)),
    ("conv1d_transpose", X3, (4, 2, 2), dict(groups=2, dilation=2,
                                             padding="SAME")),
    ("conv2d_transpose", X4, (4, 3, 3, 2), dict(stride=2, padding=[1, 0])),
    ("conv2d_transpose", X4, (4, 2, 3, 3), dict(
        stride=[2, 1], padding=[1, 2, 0, 1], output_padding=[1, 0],
        groups=2)),
    ("conv2d_transpose", last(X4), (4, 3, 2, 2), dict(
        padding="VALID", data_format="NHWC")),
    ("conv3d_transpose", X5, (4, 2, 2, 2, 3), dict(stride=2, padding=1,
                                                   output_padding=1)),
]


@pytest.mark.parametrize("name,x,wshape,kw", CONVS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CONVS)])
def test_conv_functional(name, x, wshape, kw):
    w = arr(wshape, seed=7)
    both(name, (x, w, arr((wshape[0] if "transpose" not in name else
                           wshape[1] * kw.get("groups", 1),), seed=8)), kw)


def test_conv_layers():
    """Every convolution layer on the reference's weights, with bias and
    without; the weights' shapes and their initial spread; a transposed
    layer's ``output_size`` (no effect in either package) and string
    padding above stride 1 (refused by both)."""
    cases = [
        (jnn.Conv1D(4, 6, 3, padding=1), tnn.Conv1D(4, 6, 3, padding=1), X3),
        (jnn.Conv2D(4, 4, 3, stride=2, groups=2), tnn.Conv2D(
            4, 4, 3, stride=2, groups=2), X4),
        (jnn.Conv3D(4, 2, 2, bias_attr=False), tnn.Conv3D(
            4, 2, 2, bias_attr=False), X5),
        (jnn.Conv1DTranspose(4, 3, 3, stride=2), tnn.Conv1DTranspose(
            4, 3, 3, stride=2), X3),
        (jnn.Conv2DTranspose(4, 6, 3, stride=2, padding=1, output_padding=1,
                             groups=2),
         tnn.Conv2DTranspose(4, 6, 3, stride=2, padding=1, output_padding=1,
                             groups=2), X4),
        (jnn.Conv3DTranspose(4, 2, 2, stride=2), tnn.Conv3DTranspose(
            4, 2, 2, stride=2), X5)]
    for jl, tl, x in cases:
        assert [list(p.shape) for p in tl.parameters()] == \
            [list(p.shape) for p in jl.parameters()]
        compare_layers(jl, tl, (x,), rel=REL)
    std = tnn.Conv2D(16, 8, 3).weight.numpy().std()
    assert abs(std - np.sqrt(2 / (16 * 9))) < 0.2 * np.sqrt(2 / (16 * 9))
    jl, tl = jnn.Conv2DTranspose(4, 3, 2), tnn.Conv2DTranspose(4, 3, 2)
    carry(jl, tl)
    compare(lambda a: jl(a, output_size=[8, 7]),
            lambda a: tl(a, output_size=[8, 7]), (X4,), rel=REL)
    w = arr((4, 3, 2, 2), seed=9)
    for pkg, F in ((paddle_tpu, JF), (pt, TF)):
        with pytest.raises(ValueError):  # string padding above stride 1
            F.conv2d_transpose(pkg.to_tensor(X4), pkg.to_tensor(w), stride=2,
                               padding="SAME")


def test_conv_padding_modes():
    """A named departure: "reflect", "replicate" and "circular" pad the
    input that way, then convolve with none (the reference raises)."""
    with pytest.raises(NotImplementedError):
        jnn.Conv2D(4, 2, 3, padding_mode="reflect")
    for mode in ("reflect", "replicate", "circular"):
        for fmt, x in (("NCHW", X4), ("NHWC", last(X4))):
            tl = tnn.Conv2D(4, 2, 3, padding=[1, 2], padding_mode=mode,
                            data_format=fmt)
            jl = jnn.Conv2D(4, 2, 3, data_format=fmt)
            carry(jl, tl)
            compare(lambda a: jl(JF.pad(a, [2, 2, 1, 1], mode=mode,
                                        data_format=fmt)),
                    tl, (x,), rel=REL)


# (functional, x, args, kwargs)
POOLS = [
    ("max_pool1d", X3, (3,), dict(stride=2, padding=1)),
    ("max_pool2d", X4, (3,), dict(stride=2, padding=1, ceil_mode=True)),
    ("max_pool2d", last(X4), ([2, 3],), dict(data_format="NHWC")),
    ("max_pool3d", X5, (2,), dict(ceil_mode=True)),
    ("avg_pool1d", X3, (2,), dict(padding=1, exclusive=False)),
    ("avg_pool2d", X4, (3,), dict(stride=2, padding=1)),
    ("avg_pool2d", X4, (3,), dict(stride=2, padding=1, exclusive=False,
                                  ceil_mode=True)),
    ("avg_pool3d", last(X5), (2,), dict(stride=1, data_format="NDHWC")),
    ("adaptive_avg_pool1d", X3, (3,), {}),
    ("adaptive_avg_pool2d", X4, ([7, 3],), {}),
    ("adaptive_avg_pool3d", X5, ([5, 2, 4],), {}),
    ("adaptive_max_pool1d", X3, (4,), {}),
    ("adaptive_max_pool2d", X4, ([1, 2],), {}),
    ("adaptive_max_pool3d", X5, (1,), {}),
]


@pytest.mark.parametrize("name,x,args,kw", POOLS,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(POOLS)])
def test_pool_functional(name, x, args, kw):
    both(name, (x,) + args, kw)


def _plane_argmax(x, k, s, p, ceil_mode=False):
    """The max pool's (out, flat index within the input plane) of a
    ``[N, C, H, W]`` array, by loops."""
    N, C, H, W = x.shape

    def count(n, kk, ss, pp):
        span = n + 2 * pp - kk
        return (-(-span // ss) if ceil_mode else span // ss) + 1

    oh, ow = count(H, k, s, p), count(W, k, s, p)
    out = np.zeros((N, C, oh, ow), x.dtype)
    idx = np.zeros((N, C, oh, ow), np.int64)
    for i in range(oh):
        for j in range(ow):
            h0, w0 = i * s - p, j * s - p
            hs, ws = range(max(h0, 0), min(h0 + k, H)), \
                range(max(w0, 0), min(w0 + k, W))
            win = x[:, :, hs.start:hs.stop, ws.start:ws.stop].reshape(N, C, -1)
            a = win.argmax(-1)
            out[:, :, i, j] = win.max(-1)
            idx[:, :, i, j] = (hs.start + a // len(ws)) * W + ws.start \
                + a % len(ws)
    return out, idx


def test_max_pool_masks_and_same_padding():
    """Named departures: ``return_mask`` gives the index of each maximum
    flat within its input plane (torch's padded and unpadded routes
    alike, NHWC too, and on the adaptive pools); "SAME"/"VALID" padding
    is XLA's."""
    for k, s, p, ceil in ((3, 2, 1, False), (3, 2, 1, True), (2, 2, 0, True),
                          (3, 1, 2, False)):
        want, widx = _plane_argmax(X4, k, s, p, ceil)
        out, mask = TF.max_pool2d(pt.to_tensor(X4), k, s, p,
                                  return_mask=True, ceil_mode=ceil)
        np.testing.assert_array_equal(out.numpy(), want)
        np.testing.assert_array_equal(mask.numpy(), widx)
        jo = JF.max_pool2d(paddle_tpu.to_tensor(X4), k, s, p,
                           return_mask=True, ceil_mode=ceil)
        np.testing.assert_array_equal(jo.numpy(), want)
        lo, lm = tnn.MaxPool2D(k, s, p, ceil, return_mask=True,
                               data_format="NHWC")(pt.to_tensor(last(X4)))
        np.testing.assert_array_equal(lm.numpy(), last(widx))
    out, mask = TF.adaptive_max_pool2d(pt.to_tensor(X4), 3,
                                       return_mask=True)
    flat = X4.reshape(2, 4, -1)
    np.testing.assert_array_equal(
        np.take_along_axis(flat, mask.numpy().reshape(2, 4, -1), -1),
        out.numpy().reshape(2, 4, -1))
    _, m1 = TF.max_pool1d(pt.to_tensor(X3), 4, 3, 1, return_mask=True)
    assert list(m1.shape) == [2, 4, 3]
    with pytest.raises(NotImplementedError):
        JF.max_pool2d(paddle_tpu.to_tensor(X4), 3, padding="SAME")
    same = TF.max_pool2d(pt.to_tensor(X4), 3, 2, "SAME")
    # SAME on 7 x 6 with k 3, s 2: 4 x 3 outputs, pads (1, 1) and (0, 1)
    xp = np.pad(X4, ((0, 0), (0, 0), (1, 1), (0, 1)),
                constant_values=-np.inf)
    want = _plane_argmax(xp, 3, 2, 0)[0]
    np.testing.assert_array_equal(same.numpy(), want)
    valid = TF.avg_pool2d(pt.to_tensor(X4), 2, 2, "VALID")
    np.testing.assert_allclose(valid.numpy(), X4[:, :, :6].reshape(
        2, 4, 3, 2, 3, 2).mean((3, 5)), rtol=1e-6)


def test_pool_layers():
    for name, args, x in (
            ("MaxPool1D", (2,), X3), ("MaxPool2D", (3, 2, 1), X4),
            ("MaxPool3D", (2, 1), X5), ("AvgPool1D", (3, 2, 1), X3),
            ("AvgPool2D", (2,), X4), ("AvgPool3D", (2, 2, 1), X5),
            ("AdaptiveAvgPool1D", (4,), X3),
            ("AdaptiveAvgPool2D", ([7, 2],), X4),
            ("AdaptiveAvgPool3D", ([1, 3, 2],), X5),
            ("AdaptiveMaxPool1D", (3,), X3),
            ("AdaptiveMaxPool2D", ([1, 3],), X4),
            ("AdaptiveMaxPool3D", (1,), X5)):
        compare_layers(getattr(jnn, name)(*args), getattr(tnn, name)(*args),
                       (x,), rel=REL)
