"""The port's common functionals and layers (and the containers
``ParameterList`` and ``LayerDict``) against paddle_tpu's, with the
helpers and tolerances of ``test_torch_nn_activation.py``: float32
outputs within rtol 1e-5 / atol 1e-6, input and parameter gradients
within 1e-5 of their largest value; ``interpolate`` in every mode the
reference takes, NCHW and NHWC, up and down.

Random names (the dropouts, ``class_center_sample``) are held by shape
and statistics: which elements or channels survive, their scaling, and
the same output from the same generator state.
"""
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from test_torch_nn_activation import compare, compare_layers
from test_torch_ops_math import arr, cpu_device  # noqa: F401

X4 = arr((2, 3, 5, 6), seed=21)
NHWC = np.moveaxis(X4, 1, -1).copy()


# (mode, size or None, scale factor or None, data_format)
RESIZE = [
    ("nearest", (8, 9), None, "NCHW"), ("nearest", (3, 4), None, "NCHW"),
    ("nearest", None, 2, "NHWC"), ("bilinear", (9, 11), None, "NCHW"),
    ("bilinear", (3, 4), None, "NCHW"), ("bilinear", None, 1.5, "NHWC"),
    ("bicubic", (8, 10), None, "NCHW"), ("bicubic", (3, 3), None, "NHWC"),
    ("area", (2, 3), None, "NCHW"), ("linear", (11,), None, "NCL"),
    ("trilinear", (4, 6, 3), None, "NCDHW"),
]


@pytest.mark.parametrize("mode,size,scale,fmt", RESIZE,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(RESIZE)])
def test_interpolate(mode, size, scale, fmt):
    x = {"NCHW": X4, "NHWC": NHWC, "NCL": X4[:, :, 0],
         "NCDHW": arr((1, 2, 3, 4, 5), seed=2)}[fmt]
    kw = dict(size=size, scale_factor=scale, mode=mode, data_format=fmt)
    compare(JF.interpolate, TF.interpolate, (x,), kw=kw)


def test_upsample_and_its_layers():
    """``upsample`` is ``interpolate``; ``align_corners``/``align_mode``
    change nothing in either package (the reference's function)."""
    kw = dict(size=(7, 8), mode="bilinear", align_corners=True, align_mode=1)
    compare(JF.upsample, TF.upsample, (X4,), kw=kw)
    compare(JF.upsample, TF.interpolate, (X4,), kw=kw)
    for name, args in (("Upsample", ((4, 9), None, "bicubic")),
                       ("UpsamplingNearest2D", (None, 2)),
                       ("UpsamplingBilinear2D", ((8, 8),))):
        compare_layers(getattr(jnn, name)(*args), getattr(tnn, name)(*args),
                       (X4,))


def test_embedding_padding_rows():
    """Rows at ``padding_idx`` are zeros and send no gradient; a negative
    ``padding_idx`` matches no id in the functional (both packages) and
    counts from the end in the layer."""
    w = arr((10, 4), seed=3)
    ids = np.array([[0, 3, 9], [3, 3, 1]], np.int64)
    for pad in (None, 3, -1):
        compare(lambda a, b: JF.embedding(a, b, padding_idx=pad),
                lambda a, b: TF.embedding(a, b, padding_idx=pad), (ids, w))
    for pad in (None, 3, -1):
        # the reference's constructor cannot zero the padding row under
        # JAX 0.9 (it writes into a read-only numpy view of the weight:
        # ROADMAP queue C's caveats), so the test does what it would
        jl = jnn.Embedding(10, 4)
        tl = tnn.Embedding(10, 4, padding_idx=pad, sparse=True)
        if pad is not None:
            jl._padding_idx = pad % 10
            w0 = jl.weight.numpy().copy()
            w0[pad] = 0
            jl.weight.set_value(w0)
            assert not tl.weight.numpy()[pad].any()
        compare_layers(jl, tl, (ids,))


def test_one_hot_and_label_smooth():
    ids = np.array([[0, 4], [2, 7]], np.int64)
    jo, to = compare(JF.one_hot, TF.one_hot, (ids, 5), grad=False)
    assert str(to[0].dtype) == "paddle.float32" or "float32" in str(
        to[0].dtype)
    oh = np.eye(6, dtype=np.float32)[[1, 5, 0]]
    compare(JF.label_smooth, TF.label_smooth, (oh,), kw=dict(epsilon=0.2))
    prior = np.linspace(0.1, 0.2, 6).astype(np.float32)
    compare(lambda a: JF.label_smooth(a, paddle_tpu.to_tensor(prior)),
            lambda a: TF.label_smooth(a, pt.to_tensor(prior)), (oh,))


def test_cosine_similarity_bilinear_pixel_shuffle_unfold():
    a, b = arr((3, 5, 4), seed=4), arr((3, 5, 4), seed=5)
    compare(JF.cosine_similarity, TF.cosine_similarity, (a, b))
    compare(JF.cosine_similarity, TF.cosine_similarity, (a, b),
            kw=dict(axis=-1, eps=1e-3))
    x1, x2 = arr((4, 3), seed=6), arr((4, 5), seed=7)
    w, bias = arr((2, 3, 5), seed=8), arr((2,), seed=9)
    compare(JF.bilinear, TF.bilinear, (x1, x2, w, bias))
    compare(JF.bilinear, TF.bilinear, (x1, x2, w))
    ps = arr((2, 8, 3, 3), seed=10)
    compare(JF.pixel_shuffle, TF.pixel_shuffle, (ps, 2))
    compare(JF.pixel_shuffle, TF.pixel_shuffle,
            (np.moveaxis(ps, 1, -1).copy(), 2), kw=dict(data_format="NHWC"))
    for kw in (dict(kernel_sizes=2), dict(kernel_sizes=[2, 3], strides=2,
                                          paddings=[1, 0], dilations=[1, 2])):
        compare(JF.unfold, TF.unfold, (X4,), kw=kw)


def test_pad_modes_and_layers():
    for mode in ("constant", "reflect", "replicate", "circular"):
        compare(lambda a: JF.pad(a, [1, 2, 0, 1], mode=mode, value=0.5),
                lambda a: TF.pad(a, [1, 2, 0, 1], mode=mode, value=0.5),
                (X4,))
    x3, x5 = X4[:, :, 0], arr((1, 2, 3, 3, 4), seed=11)
    for name, x, args in (("Pad1D", x3, ([1, 2], "reflect")),
                          ("Pad2D", X4, ([1, 0, 2, 1], "replicate")),
                          ("Pad3D", x5, ([1, 1, 0, 2, 1, 0], "constant",
                                         0.3))):
        compare_layers(getattr(jnn, name)(*args), getattr(tnn, name)(*args),
                       (x,))


def test_parameter_free_layers():
    a, b = arr((3, 6), seed=12), arr((3, 6), seed=13)
    compare_layers(jnn.Identity(4, foo=1), tnn.Identity(4, foo=1), (a,))
    compare_layers(jnn.CosineSimilarity(axis=-1), tnn.CosineSimilarity(
        axis=-1), (a, b))
    for p, keep in ((2.0, False), (1.0, True), (3.0, False)):
        compare_layers(jnn.PairwiseDistance(p, keepdim=keep),
                       tnn.PairwiseDistance(p, keepdim=keep), (a, b))
    compare_layers(jnn.PixelShuffle(2), tnn.PixelShuffle(2),
                   (arr((1, 4, 2, 3), seed=14),))
    assert tnn.vision.PixelShuffle is tnn.PixelShuffle
    compare_layers(jnn.Unfold([2, 2], 1, 1), tnn.Unfold([2, 2], 1, 1), (X4,))


def test_bilinear_layer():
    jl, tl = jnn.Bilinear(3, 5, 2), tnn.Bilinear(3, 5, 2)
    assert list(tl.weight.shape) == [2, 3, 5] and list(tl.bias.shape) == [2]
    assert np.abs(tl.weight.numpy()).max() <= 1 / np.sqrt(3)
    compare_layers(jl, tl, (arr((4, 3), seed=15), arr((4, 5), seed=16)))


def test_dropouts_by_statistics():
    """Same generator state -> same mask; in training ``dropout2d``/``3d``
    drop whole channels and scale the rest by 1 / (1 - p); in eval they
    are the identity; ``alpha_dropout`` keeps the mean and variance of
    SELU-normal inputs."""
    x = pt.to_tensor(np.ones((8, 16, 4, 4), np.float32))
    out = TF.dropout2d(x, 0.5, generator=torch.Generator().manual_seed(0))
    o = out.numpy()
    per_channel = o.reshape(8, 16, -1)
    assert ((per_channel == 0).all(-1) | (per_channel == 2.0).all(-1)).all()
    assert 0.3 < (per_channel[..., 0] == 0).mean() < 0.7
    again = TF.dropout2d(x, 0.5, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again.numpy(), o)
    x5 = pt.to_tensor(np.ones((4, 8, 2, 3, 3), np.float32))
    o5 = TF.dropout3d(x5, 0.25).numpy().reshape(4, 8, -1)
    assert ((o5 == 0).all(-1) | np.isclose(o5, 1 / 0.75).all(-1)).all()
    jo = JF.dropout2d(paddle_tpu.to_tensor(x.numpy()), 0.5).numpy()
    assert jo.shape == o.shape and set(np.unique(jo)) <= {0.0, 2.0}
    for name, cls_args in (("Dropout2D", (0.5,)), ("Dropout3D", (0.5,)),
                           ("AlphaDropout", (0.2,))):
        layer = getattr(tnn, name)(*cls_args)
        layer.eval()
        inp = x5 if name == "Dropout3D" else x
        np.testing.assert_array_equal(layer(inp).numpy(), inp.numpy())
    z = pt.to_tensor(np.random.RandomState(0).randn(200000).astype(
        np.float32))
    a = TF.alpha_dropout(z, 0.2, generator=torch.Generator().manual_seed(1))
    av = a.numpy()
    assert abs(av.mean()) < 0.02 and abs(av.std() - 1.0) < 0.02
    ja = JF.alpha_dropout(paddle_tpu.to_tensor(z.numpy()), 0.2).numpy()
    assert abs(ja.mean()) < 0.02 and abs(ja.std() - 1.0) < 0.02
    _, counts = np.unique(av, return_counts=True)
    assert 0.18 < counts.max() / av.size < 0.22  # the dropped value


def test_class_center_sample():
    """A named departure: the JAX package raises here; the port samples
    every class present, ascending, then negatives, and remaps labels to
    their index in the sample."""
    with pytest.raises(NotImplementedError):
        JF.class_center_sample(paddle_tpu.to_tensor(np.array([1, 2])), 10,
                               4)
    label = pt.to_tensor(np.array([7, 2, 7, 11, 2], np.int64))
    remap, centers = TF.class_center_sample(
        label, 20, 8, generator=torch.Generator().manual_seed(0))
    c = centers.numpy()
    assert len(c) == 8 and len(set(c)) == 8
    np.testing.assert_array_equal(c[:3], [2, 7, 11])
    np.testing.assert_array_equal(c[remap.numpy()], label.numpy())
    _, all_pos = TF.class_center_sample(label, 20, 2)
    np.testing.assert_array_equal(all_pos.numpy(), [2, 7, 11])


def test_containers_carry_state():
    """``ParameterList`` names its parameters "0", "1", ...; ``LayerDict``
    its sublayers by key, as the JAX package's do."""
    jpl = jnn.ParameterList([jnn.Linear(2, 3).weight, jnn.Linear(3, 1).bias])
    tpl = tnn.ParameterList([tnn.Linear(2, 3).weight, tnn.Linear(3, 1).bias])
    state = {k: np.asarray(v._data) for k, v in jpl.state_dict().items()}
    assert list(state) == ["0", "1"] and tpl.set_state_dict(state) == (
        [], [])
    assert len(tpl) == 2 and [tuple(p.shape) for p in tpl] == [(2, 3), (1,)]
    tpl.append(tnn.Linear(1, 1).bias)
    assert list(tpl.state_dict())[-1] == "2"
    jld = jnn.LayerDict({"a": jnn.Linear(2, 3), "b": jnn.ReLU()})
    tld = tnn.LayerDict({"a": tnn.Linear(2, 3), "b": tnn.ReLU()})
    state = {k: np.asarray(v._data) for k, v in jld.state_dict().items()}
    assert tld.set_state_dict(state) == ([], [])
    assert list(tld.keys()) == list(jld.keys()) and "a" in tld
    x = arr((4, 2), seed=17)
    np.testing.assert_allclose(
        tld["a"](pt.to_tensor(x)).numpy(),
        jld["a"](paddle_tpu.to_tensor(x)).numpy(), rtol=1e-5, atol=1e-6)
    tld.pop("b")
    assert list(tld) == ["a"] and len(tld) == 1
    # the layer modules by name, as in the JAX package
    for mod, name in (("container", "LayerDict"), ("conv", "Conv1D"),
                      ("common", "Identity"), ("loss", "NLLLoss"),
                      ("norm", "GroupNorm"), ("pooling", "MaxPool3D"),
                      ("vision", "PixelShuffle")):
        assert getattr(getattr(tnn, mod), name) is getattr(tnn, name)
        assert hasattr(getattr(jnn, mod), name)
