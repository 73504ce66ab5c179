"""The port's fluid-era functional tail (``nn/functional/extras.py``)
against paddle_tpu's, name by name.

Each case gives both packages the same seeded numpy inputs (float32) and
compares every output within rtol 1e-5 / atol 1e-6 (``rel``: within that
share of the largest output), then the gradients of ``sum(out * w)`` for
the float inputs within 1e-5 of their largest value (``compare`` of
``test_torch_nn_activation.py``). Functions that build fresh parameters
(``fc``, ``bilinear_tensor_product``) get them from ``Assign``
initializers of the same numpy values; the random ones (``random_crop``,
``nce``) are held by what a draw must satisfy, and ``nce`` by value with
its noise classes fixed in both packages. ``rnn``/``birnn`` are in
``test_torch_rnn.py``. ``tests/test_functional_extras.py``'s checks are
repeated on the port where a parity case does not already hold them.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu.core import random as jrandom
from paddle_tpu.nn.functional import extras as jx

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn.functional import extras as tx
from test_torch_nn_activation import compare
from test_torch_ops_math import arr, cpu_device  # noqa: F401

JF, TF = jnn.functional, tnn.functional

X4 = arr((2, 4, 6, 6), seed=1)
THETA = arr((2, 2, 3), -1.0, 1.0, seed=2)
GRID = arr((2, 3, 5, 2), -1.2, 1.2, seed=3)
IMG = arr((2, 3, 6, 8), seed=4)


def both(name, *a, **kw):
    """``name`` of both modules with the same arguments bound."""
    return (lambda *x: getattr(JF, name)(*x, *a, **kw),
            lambda *x: getattr(TF, name)(*x, *a, **kw))


# (id, name, bound args, keyword args, inputs, grad, rel)
CASES = [
    ("affine_grid", "affine_grid", ((2, 3, 5, 4),), {}, (THETA,), True,
     None),
    ("affine_grid_half_pixel", "affine_grid", ((2, 3, 5, 4),),
     dict(align_corners=False), (THETA,), True, None),
    ("grid_sample", "grid_sample", (), {}, (IMG, GRID), True, None),
    ("grid_sample_border", "grid_sample", (),
     dict(padding_mode="border", align_corners=False), (IMG, GRID), True,
     None),
    ("grid_sample_reflection", "grid_sample", (),
     dict(padding_mode="reflection"), (IMG, GRID), True, None),
    ("grid_sample_reflection_half_pixel", "grid_sample", (),
     dict(padding_mode="reflection", align_corners=False), (IMG, GRID),
     True, None),
    ("grid_sample_nearest", "grid_sample", (), dict(mode="nearest"),
     (IMG, GRID), True, None),
    ("space_to_depth", "space_to_depth", (2,), {}, (X4,), True, None),
    ("shuffle_channel", "shuffle_channel", (2,), {}, (X4,), True, None),
    ("temporal_shift", "temporal_shift", (2,), dict(shift_ratio=0.25),
     (arr((4, 8, 2, 2)),), True, None),
    ("soft_relu", "soft_relu", (), dict(threshold=1.5), (X4 * 4,), True,
     None),
    ("add_position_encoding", "add_position_encoding", (0.5, 2.0), {},
     (arr((2, 5, 8)),), True, None),
    ("fsp_matrix", "fsp_matrix", (), {}, (X4, arr((2, 3, 6, 6), seed=5)),
     True, None),
    ("pad_constant_like", "pad_constant_like", (), dict(pad_value=0.5),
     (arr((2, 5, 4)), arr((2, 3, 4), seed=6)), True, None),
    ("pad2d", "pad2d", ((1, 0, 2, 1),), {}, (X4,), True, None),
    ("pad2d_reflect_nhwc", "pad2d", ((1, 2, 2, 1),),
     dict(mode="reflect", data_format="NHWC"), (X4,), True, None),
    ("image_resize", "image_resize", ([9, 5],), {}, (X4,), True, None),
    ("resize_bilinear", "resize_bilinear", (), dict(scale=1.5), (X4,),
     True, None),
    ("resize_nearest", "resize_nearest", ([3, 12],), {}, (X4,), True, None),
    ("resize_trilinear", "resize_trilinear", ([3, 4, 5],), {},
     (arr((1, 2, 4, 6, 6)),), True, 1e-5),
    ("image_resize_short", "image_resize_short", (4,), {}, (IMG,), True,
     1e-5),
    ("pool2d", "pool2d", (3, "max", 2), dict(pool_padding=1), (X4,), True,
     None),
    ("pool2d_avg_ceil_nhwc", "pool2d", (2, "avg", 2),
     dict(ceil_mode=True, exclusive=False, data_format="NHWC"),
     (arr((2, 5, 5, 3)),), True, None),
    ("pool2d_global", "pool2d", (), dict(global_pooling=True,
                                         pool_type="avg"), (X4,), True,
     None),
    ("pool3d", "pool3d", (2, "avg", 2), {}, (arr((1, 2, 4, 4, 4)),), True,
     None),
    ("pool3d_global_ndhwc", "pool3d", (),
     dict(global_pooling=True, data_format="NDHWC"),
     (arr((1, 4, 4, 4, 2)),), True, None),
]


@pytest.mark.parametrize("name,args,kw,inputs,grad,rel",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_op(name, args, kw, inputs, grad, rel):
    jf, tf = both(name, *args, **kw)
    compare(jf, tf, inputs, grad=grad, rel=rel)


def test_affine_channel_and_losses():
    """``affine_channel`` (NCHW, NHWC, scale only), ``dice_loss`` (one-hot
    and dense labels), ``bpr_loss``, ``smooth_l1`` (weights, sigma)."""
    s, b = arr((4,), seed=7), arr((4,), seed=8)
    compare(JF.affine_channel, TF.affine_channel, (X4, s, b))
    compare(lambda x, w: JF.affine_channel(x, w, data_layout="NHWC"),
            lambda x, w: TF.affine_channel(x, w, data_layout="NHWC"),
            (arr((2, 3, 3, 4)), s))
    p = arr((4, 3, 5), 0.0, 1.0, seed=9)
    lbl = np.random.RandomState(0).randint(0, 5, (4, 3, 1)).astype(np.int64)
    compare(JF.dice_loss, TF.dice_loss, (p, lbl))
    compare(JF.dice_loss, TF.dice_loss, (p, arr((4, 3, 5), 0, 1, seed=10)))
    compare(JF.bpr_loss, TF.bpr_loss,
            (arr((4, 6), -2, 2), np.array([0, 5, 2, 3], np.int64)))
    x, y = arr((3, 5), -2, 2, seed=11), arr((3, 5), -2, 2, seed=12)
    iw, ow = arr((3, 5), 0, 2, seed=13), arr((3, 5), 0, 2, seed=14)
    compare(lambda a, c, d, e: JF.smooth_l1(a, c, d, e, sigma=2.0),
            lambda a, c, d, e: TF.smooth_l1(a, c, d, e, sigma=2.0),
            (x, y, iw, ow))
    compare(JF.smooth_l1, TF.smooth_l1, (x, y))


def test_roi_pool():
    feat = arr((2, 3, 8, 8), seed=15)
    boxes = np.array([[0.0, 0.0, 7.0, 7.0], [1.2, 2.0, 5.6, 6.1],
                      [2.0, 1.0, 9.0, 4.0]], np.float32)
    num = np.array([2, 1], np.int32)
    for size, scale in ((2, 1.0), ((3, 2), 0.5)):
        compare(lambda f, bx, n: JF.roi_pool(f, bx, n, size, scale),
                lambda f, bx, n: TF.roi_pool(f, bx, n, size, scale),
                (feat, boxes, num))
    # test_functional_extras.py: the max reaches its bin
    x = np.zeros((1, 1, 8, 8), np.float32)
    x[0, 0, 2, 3] = 9.0
    out = TF.roi_pool(pt.to_tensor(x), pt.to_tensor(boxes[:1]),
                      pt.to_tensor(np.array([1], np.int32)), 2).numpy()
    assert out.shape == (1, 1, 2, 2) and out.max() == 9.0


def test_density_prior_box():
    """Equal to the JAX package's boxes, every option; and its named
    departure pinned: without ``clip`` the corners are not clamped to
    [0, 1] (upstream's kernel clamps them)."""
    inp = np.zeros((1, 3, 2, 3), np.float32)
    img = np.zeros((1, 3, 16, 20), np.float32)
    for kw in (dict(), dict(clip=True, flatten_to_2d=True),
               dict(steps=(4.0, 6.0), offset=0.3,
                    variance=(0.1, 0.2, 0.3, 0.4))):
        args = dict(densities=[2, 1], fixed_sizes=[4.0, 6.0],
                    fixed_ratios=[1.0, 2.0], **kw)
        jb, jv = JF.density_prior_box(paddle_tpu.to_tensor(inp),
                                      paddle_tpu.to_tensor(img), **args)
        tb, tv = TF.density_prior_box(pt.to_tensor(inp), pt.to_tensor(img),
                                      **args)
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb._data))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv._data))
    raw = TF.density_prior_box(pt.to_tensor(inp), pt.to_tensor(img), [2],
                               [8.0], [2.0])[0].numpy()
    assert raw.min() < 0.0  # unclamped: the departure from upstream


def test_spectral_norm():
    w = arr((6, 4, 3), seed=16) * 3
    for dim, iters in ((0, 1), (1, 3)):
        compare(lambda a: JF.spectral_norm(a, dim=dim, power_iters=iters),
                lambda a: TF.spectral_norm(a, dim=dim, power_iters=iters),
                (w,))
    out = TF.spectral_norm(pt.to_tensor(w[:, :, 0]), power_iters=50)
    assert abs(np.linalg.svd(out.numpy(), compute_uv=False)[0] - 1) < 1e-3


def test_hsigmoid_loss():
    x = arr((4, 6), seed=17)
    y = np.array([0, 2, 4, 1], np.int64)
    w, b = arr((4, 6), seed=18), arr((4,), seed=19)
    compare(lambda a, c, d, e: JF.hsigmoid_loss(a, c, 5, d, e),
            lambda a, c, d, e: TF.hsigmoid_loss(a, c, 5, d, e), (x, y, w, b))
    table = np.array([[0, 1, -1], [0, 2, 3], [1, -1, -1], [2, 3, 0]],
                     np.int64)
    code = np.array([[1, 0, 0], [0, 1, 1], [1, 0, 0], [0, 0, 1]], np.int64)
    compare(lambda a, c, d, t, k: JF.hsigmoid_loss(a, c, 4, d, None, t, k),
            lambda a, c, d, t, k: TF.hsigmoid_loss(a, c, 4, d, None, t, k),
            (x, np.array([0, 2, 3, 1], np.int64), w, table, code))


def test_nce(monkeypatch):
    """The reference draws its noise from ``next_key()``: fixed here, and
    the same classes handed to the port's draw, which names a
    ``torch.Generator`` (the caller's when given)."""
    B, dim, ncls, nneg = 4, 6, 10, 3
    key = jax.random.PRNGKey(3)
    monkeypatch.setattr(jrandom, "next_key", lambda: key)
    noise = torch.as_tensor(np.array(
        jax.random.randint(key, (B, nneg), 0, ncls)), dtype=torch.int64)
    draws = []

    def fixed(low, high, size, generator=None, device=None):
        assert (low, high, tuple(size)) == (0, ncls, (B, nneg))
        draws.append(generator)
        return noise

    monkeypatch.setattr(torch, "randint", fixed)
    x, y = arr((B, dim), seed=20), np.array([1, 0, 7, 9], np.int64)
    w, b = arr((ncls, dim), seed=21), arr((ncls,), seed=22)
    compare(lambda a, c, d, e: JF.nce(a, c, ncls, nneg, weight=d, bias=e),
            lambda a, c, d, e: TF.nce(a, c, ncls, nneg, weight=d, bias=e),
            (x, y, w, b))
    gen = torch.Generator().manual_seed(0)
    TF.nce(pt.to_tensor(x), pt.to_tensor(y), ncls, nneg,
           weight=pt.to_tensor(w), generator=gen)
    assert all(isinstance(g, torch.Generator) for g in draws)
    assert draws[-1] is gen
    with pytest.raises(NotImplementedError):
        TF.nce(pt.to_tensor(x), pt.to_tensor(y), ncls, sampler="log_uniform",
               weight=pt.to_tensor(w))


def test_warpctc():
    T, B, C, S = 6, 2, 5, 3
    logits = arr((T, B, C), -2, 2, seed=23)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    lbl = np.array([[1, 2, 2], [3, 1, 0]], np.int64)
    il, ll = np.array([6, 5], np.int64), np.array([3, 2], np.int64)
    compare(lambda a, c, d, e: JF.warpctc(a, c, input_length=d,
                                          label_length=e),
            lambda a, c, d, e: TF.warpctc(a, c, input_length=d,
                                          label_length=e),
            (logp, lbl, il, ll), rel=1e-5)
    with pytest.raises(NotImplementedError):
        TF.warpctc(pt.to_tensor(logp), pt.to_tensor(lbl))


def test_fc_and_bilinear_tensor_product():
    """Fresh parameters per call, here from ``Assign`` of the same
    values: ``fc`` over one input (flattened from axis 1, and from axis 2)
    and over two, with an activation; ``bilinear_tensor_product``."""
    x3 = arr((2, 3, 4), seed=24)
    w12, w4 = arr((12, 5), seed=25), arr((4, 5), seed=26)
    bias = arr((5,), seed=27)

    def attrs(pkg, w):
        return dict(param_attr=pkg.ParamAttr(
            initializer=pkg.initializer.Assign(w)),
            bias_attr=pkg.ParamAttr(initializer=pkg.initializer.Assign(
                bias)))

    for nfd, w, act in ((1, w12, None), (2, w4, "relu")):
        compare(lambda a: JF.fc(a, 5, nfd, act=act, **attrs(jnn, w)),
                lambda a: TF.fc(a, 5, nfd, act=act, **attrs(tnn, w)), (x3,))
    x2 = arr((3, 4), seed=28)
    compare(lambda a, c: JF.fc([a, c], 5, act="tanh", **attrs(jnn, w4)),
            lambda a, c: TF.fc([a, c], 5, act="tanh", **attrs(tnn, w4)),
            (x2, arr((3, 4), seed=29)))
    wb = arr((5, 4, 3), seed=30)
    y2 = arr((3, 3), seed=31)

    def bil(pkg, F):
        return lambda a, c: F.bilinear_tensor_product(
            a, c, 5, act="sigmoid", **attrs(pkg, wb))

    compare(bil(jnn, JF), bil(tnn, TF), (x2, y2))


def test_random_crop():
    """A window of the trailing axes, one per sample; a ``seed`` repeats
    it; a generator is drawn from; per-sample offsets differ."""
    batch = np.arange(4 * 64, dtype=np.float32).reshape(4, 1, 8, 8)
    xt = pt.to_tensor(batch)
    crops = TF.random_crop(xt, [4, 5], seed=3).numpy()
    assert crops.shape == (4, 1, 4, 5)
    for src, c in zip(batch, crops):
        r0, c0 = divmod(int(c[0, 0, 0]) % 64, 8)
        np.testing.assert_array_equal(c[0], src[0, r0:r0 + 4, c0:c0 + 5])
    np.testing.assert_array_equal(
        TF.random_crop(xt, [4, 5], seed=3).numpy(), crops)
    offs = {int(c.ravel()[0]) % 64 for c in crops}
    assert len(offs) > 1
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    a = TF.random_crop(xt, [4, 4], generator=gen).numpy()
    assert not torch.equal(gen.get_state(), state)
    gen.set_state(state)
    np.testing.assert_array_equal(
        TF.random_crop(xt, [4, 4], generator=gen).numpy(), a)
    assert TF.random_crop(pt.to_tensor(batch[0, 0]), [3, 3]).shape == [3, 3]
    j = JF.random_crop(paddle_tpu.to_tensor(batch), [4, 5])
    assert j.shape == [4, 1, 4, 5]


def test_tensor_arrays():
    """create/write/read/length and ``tensor_array_to_tensor``, both
    packages on the same values."""
    vals = [arr((2, 3), seed=s) for s in (32, 33, 34)]
    for use_stack in (False, True):
        outs = []
        for pkg, F in ((paddle_tpu, JF), (pt, TF)):
            a = F.create_array("float32")
            for i, v in enumerate(vals):
                a = F.array_write(pkg.to_tensor(v), pkg.to_tensor(
                    np.array(i)) if i else i, a)
            assert int(F.array_length(a).numpy()) == 3
            np.testing.assert_array_equal(
                F.array_read(a, 1).numpy(), vals[1])
            out, lens = F.tensor_array_to_tensor(a, axis=1,
                                                 use_stack=use_stack)
            outs.append((out.numpy(), lens.numpy()))
        np.testing.assert_array_equal(outs[1][0], outs[0][0])
        np.testing.assert_array_equal(outs[1][1], outs[0][1])
    sparse = TF.array_write(pt.to_tensor(vals[0]), 2)
    assert sparse[:2] == [None, None]


def test_every_name_is_exported():
    """Every name of the reference module, in the port's module and in
    ``nn.functional``."""
    assert set(tx.__all__) == set(jx.__all__)
    for n in jx.__all__:
        assert hasattr(TF, n), n
