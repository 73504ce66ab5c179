"""The functionals and optimizers under bench.py's vision programs, in the
port against paddle_tpu, on the same numpy inputs (float32).

``conv2d`` with every padding spelling paddle takes (ints, pairs,
asymmetric, "SAME"/"VALID"), stride, dilation and groups; ``max_pool2d``
with padding and ``ceil_mode`` (padded cells never win); the adaptive
average pool; ``flatten``; ``batch_norm``'s three forms (inference,
``use_global_stats``, batch statistics); the ``SGD`` and ``Momentum``
rules (nesterov too) against paddle_tpu's eager ``step``; the model zoo's
refusal of ``pretrained=True``; the layer names of ``Sequential``; and
``vision.ops``' deformable convolution (v1 and the modulated v2, with
deformable groups and groups) and its layer, outputs and gradients.

Tolerances: atol 1e-5 + rtol 1e-5 (float32 sums in different orders;
pooling and flatten are exact).
"""
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.manipulation import flatten as jax_flatten

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import flatten as torch_flatten
from paddle_tpu_torch.vision import models as pt_models
from paddle_tpu_torch.vision import ops as pt_vops

TOL = dict(atol=1e-5, rtol=1e-5)


def _both(*arrays):
    # copies: the port updates running statistics in place
    return ([paddle_tpu.to_tensor(a) for a in arrays],
            [torch.tensor(a) for a in arrays])


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.array(want._data),
                               **(tol or TOL))


@pytest.mark.parametrize("kw", [
    dict(padding=1), dict(padding=[1, 2]), dict(padding=[0, 1, 2, 0]),
    dict(padding=[[0, 0], [0, 0], [1, 0], [2, 1]]), dict(padding="SAME"),
    dict(padding="VALID"), dict(padding="SAME", stride=2),
    dict(padding=2, dilation=2), dict(padding=1, groups=2, stride=(2, 1))],
    ids=str)
def test_conv2d_matches(kw):
    r = np.random.RandomState(0)
    x = r.randn(2, 4, 9, 11).astype(np.float32)
    w = r.randn(6, 4 // kw.get("groups", 1), 3, 3).astype(np.float32)
    b = r.randn(6).astype(np.float32)
    (jx, jw, jb), (tx, tw, tb) = _both(x, w, b)
    _close(TF.conv2d(tx, tw, tb, **kw), JF.conv2d(jx, jw, jb, **kw))


@pytest.mark.parametrize("kw", [
    dict(kernel_size=2, stride=2), dict(kernel_size=3, stride=2, padding=1),
    dict(kernel_size=3, stride=2, padding=1, ceil_mode=True),
    dict(kernel_size=2, stride=3, ceil_mode=True),
    dict(kernel_size=3, stride=1, padding=[1, 0])], ids=str)
def test_max_pool2d_matches(kw):
    # all-negative inputs: a padded zero would win a max, -inf never does
    x = -np.random.RandomState(1).rand(2, 3, 9, 10).astype(np.float32) - 1
    (jx,), (tx,) = _both(x)
    _close(TF.max_pool2d(tx, **kw), JF.max_pool2d(jx, **kw), atol=0, rtol=0)


@pytest.mark.parametrize("size", [(1, 1), (7, 5), (1, 2), 1], ids=str)
def test_adaptive_avg_pool2d_matches(size):
    """Sizes that divide the input (paddle_tpu's fallback for sizes that
    do not raises, as does ``None`` in ``output_size``)."""
    x = np.random.RandomState(2).randn(2, 3, 7, 10).astype(np.float32)
    (jx,), (tx,) = _both(x)
    _close(TF.adaptive_avg_pool2d(tx, size),
           JF.adaptive_avg_pool2d(jx, size))


@pytest.mark.parametrize("axes", [(0, -1), (1, -1), (1, 2), (2, 3)])
def test_flatten_matches(axes):
    x = np.arange(120, dtype=np.float32).reshape(2, 3, 4, 5)
    (jx,), (tx,) = _both(x)
    _close(torch_flatten(tx, *axes), jax_flatten(jx, *axes), atol=0, rtol=0)


@pytest.mark.parametrize("mode", ["eval", "global_stats", "train"])
def test_batch_norm_forms_match(mode):
    """Inference with the running statistics, training with
    ``use_global_stats``, and training with batch statistics (output and
    the updated running statistics)."""
    r = np.random.RandomState(3)
    x = r.randn(4, 5, 6, 6).astype(np.float32) * 2 + 1
    mean = r.randn(5).astype(np.float32) * 0.1
    var = (1 + r.rand(5)).astype(np.float32)
    w, b = r.randn(5).astype(np.float32), r.randn(5).astype(np.float32)
    (jx, jm, jv, jw, jb), (tx, tm, tv, tw, tb) = _both(x, mean, var, w, b)
    kw = dict(training=mode != "eval",
              use_global_stats=True if mode == "global_stats" else None)
    _close(TF.batch_norm(tx, tm, tv, tw, tb, **kw),
           JF.batch_norm(jx, jm, jv, jw, jb, **kw))
    for t, j in ((tm, jm), (tv, jv)):
        _close(t, j)


@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov"])
def test_sgd_and_momentum_rules_match(opt):
    """Three eager steps on one parameter with the same gradients."""
    r = np.random.RandomState(4)
    p0 = r.randn(7).astype(np.float32)
    grads = [r.randn(7).astype(np.float32) for _ in range(3)]
    jp = jnn.Linear(1, 7).bias
    jp.set_value(p0)
    tp = torch.nn.Parameter(torch.as_tensor(p0.copy()))
    if opt == "sgd":
        jo = jax_optimizer.SGD(learning_rate=0.1, parameters=[jp])
        to = pt.optimizer.SGD(learning_rate=0.1, parameters=[tp])
    else:
        kw = dict(learning_rate=0.1, momentum=0.9,
                  use_nesterov=opt == "nesterov")
        jo = jax_optimizer.Momentum(parameters=[jp], **kw)
        to = pt.optimizer.Momentum(parameters=[tp], **kw)
    for g in grads:
        (jp * paddle_tpu.to_tensor(g)).sum().backward()
        jo.step()
        jo.clear_grad()
        tp.grad = torch.as_tensor(g)
        to.step()
        np.testing.assert_allclose(tp.detach().numpy(), jp.numpy(), **TOL)


def test_model_zoo_refuses_pretrained_weights():
    with pytest.raises(NotImplementedError, match="downloads nothing"):
        pt_models.resnet18(pretrained=True, device="cpu")


def test_sequential_names_its_layers_as_paddle_does():
    gen = torch.Generator().manual_seed(0)
    seq = pt.nn.Sequential(pt.nn.Linear(2, 3, device="cpu", generator=gen),
                           ("act", pt.nn.ReLU()),
                           pt.nn.Linear(3, 1, device="cpu", generator=gen))
    ref = jnn.Sequential(jnn.Linear(2, 3), ("act", jnn.ReLU()),
                         jnn.Linear(3, 1))
    assert list(seq.state_dict()) == list(ref.state_dict())
    assert isinstance(seq[1], pt.nn.ReLU) and len(seq) == 3


@pytest.mark.parametrize("kw", [
    dict(), dict(mask=True, deformable_groups=2, groups=2, stride=2,
                 padding=1, dilation=(1, 2))], ids=["v1", "v2"])
def test_deform_conv2d_matches(kw, monkeypatch):
    """Output and the gradients of x, offset, weight, bias (and mask) of
    ``sum(out * w)``, on offsets that put samples outside the image."""
    import paddle_tpu.vision.ops as jvops
    from paddle_tpu_torch.core import device as pt_device

    monkeypatch.setattr(pt_device, "_current", pt_device._current)
    pt.set_device("cpu")

    kw = dict(kw)
    use_mask, dg, g = kw.pop("mask", False), kw.get("deformable_groups",
                                                      1), kw.get("groups", 1)
    s, p = kw.get("stride", 1), kw.get("padding", 0)
    dil = kw.get("dilation", 1)
    dil = dil if isinstance(dil, tuple) else (dil, dil)
    r = np.random.RandomState(2)
    H, W = 7, 8
    Ho = (H + 2 * p - (dil[0] * 2 + 1)) // s + 1
    Wo = (W + 2 * p - (dil[1] * 2 + 1)) // s + 1
    arrays = [r.randn(2, 4, H, W), r.uniform(-2.5, 2.5, (2, 18 * dg, Ho, Wo)),
              r.randn(6, 4 // g, 3, 3), r.randn(6)]
    if use_mask:
        arrays.append(r.rand(2, 9 * dg, Ho, Wo))
    arrays = [a.astype(np.float32) for a in arrays]
    cot = r.randn(2, 6, Ho, Wo).astype(np.float32)
    res = []
    for pkg, ops in ((paddle_tpu, jvops), (pt, pt_vops)):
        ts = [pkg.to_tensor(a, stop_gradient=False) for a in arrays]
        out = ops.deform_conv2d(*ts[:4], mask=ts[4] if use_mask else None,
                                **kw)
        (out * pkg.to_tensor(cot)).sum().backward()
        res.append([out.numpy()] + [t.grad.numpy() for t in ts])
    for i, (a, b) in enumerate(zip(*res)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   err_msg=f"{i}", **TOL)
    # the layer: its weights carried, the same function
    layers = [jvops.DeformConv2D(4, 6, 3, **kw),
              pt_vops.DeformConv2D(4, 6, 3, **kw)]
    layers[1].set_state_dict({k: np.asarray(v._data) for k, v in
                              layers[0].state_dict().items()})
    outs = [lyr(pkg.to_tensor(arrays[0]), pkg.to_tensor(arrays[1]),
                mask=pkg.to_tensor(arrays[4]) if use_mask else None).numpy()
            for pkg, lyr in zip((paddle_tpu, pt), layers)]
    np.testing.assert_allclose(np.asarray(outs[1]), np.asarray(outs[0]),
                               **TOL)
