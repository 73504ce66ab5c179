"""The port's loss functionals and loss layers against paddle_tpu's, with
the helpers and tolerances of ``test_torch_nn_activation.py`` (float32
outputs within rtol 1e-5 / atol 1e-6, gradients within 1e-5 of their
largest value).

``cross_entropy`` is held with class weights, ``ignore_index``, soft
labels and ``use_softmax=False``, and the translation path's loss,
``CrossEntropyLoss(soft_label=True)`` over ``label_smooth(one_hot(.))``;
``NCELoss`` with its noise classes fixed (the reference's draw, handed
to the port's ``torch.randint``).
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import nn as jnn
from paddle_tpu.core import random as jrandom
from paddle_tpu.nn import functional as JF

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn.layers import loss as nce_module
from paddle_tpu_torch.nn import functional as TF
from test_torch_nn_activation import carry, compare, compare_layers
from test_torch_ops_math import arr, cpu_device, ints  # noqa: F401

N, C = 6, 5
LOGITS = arr((N, C), -2.0, 2.0)
LABEL = np.array([0, 3, 4, 1, 3, 2], np.int64)
IGN = np.array([0, -100, 4, 1, -100, 2], np.int64)
W = arr((C,), 0.5, 2.0, seed=1)
SOFT = np.asarray(JF.softmax(paddle_tpu.to_tensor(arr((N, C), seed=2)))._data)
PROB = arr((N, C), 0.05, 0.95, seed=3)
Y01 = (arr((N, C), seed=4) > 0).astype(np.float32)
A, B = arr((N, C), seed=5), arr((N, C), seed=6)
PM1 = np.where(arr((N,), seed=7) > 0, 1.0, -1.0).astype(np.float32)
LOGP = np.asarray(JF.log_softmax(paddle_tpu.to_tensor(LOGITS))._data)

# (functional, args, kwargs)
CASES = [
    ("cross_entropy", (LOGITS, LABEL), {}),
    ("cross_entropy", (LOGITS, LABEL[:, None]), dict(reduction="sum")),
    ("cross_entropy", (LOGITS, IGN), dict(weight=W)),
    ("cross_entropy", (LOGITS, IGN), dict(weight=W, reduction="none")),
    ("cross_entropy", (LOGITS, SOFT), dict(soft_label=True)),
    ("cross_entropy", (PROB, LABEL), dict(use_softmax=False)),
    ("cross_entropy", (np.moveaxis(arr((2, 3, C), seed=8), 1, 2).copy(),
                       ints((2, 3), 0, C)), dict(axis=1)),
    ("binary_cross_entropy", (PROB, Y01), {}),
    ("binary_cross_entropy", (PROB, Y01), dict(weight=W, reduction="sum")),
    ("binary_cross_entropy_with_logits", (A, Y01), {}),
    ("binary_cross_entropy_with_logits", (A, Y01),
     dict(weight=W, pos_weight=W[::-1].copy(), reduction="none")),
    ("mse_loss", (A, B), {}), ("l1_loss", (A, B), dict(reduction="sum")),
    ("nll_loss", (LOGP, IGN), dict(weight=W)),
    ("nll_loss", (LOGP, LABEL), dict(reduction="none")),
    ("kl_div", (LOGP, SOFT), {}), ("kl_div", (LOGP, SOFT),
                                   dict(reduction="batchmean")),
    ("smooth_l1_loss", (A * 3, B), dict(delta=0.5)),
    ("margin_ranking_loss", (A[:, 0], B[:, 0], PM1), dict(margin=0.1)),
    ("hinge_embedding_loss", (A[:, 0], PM1), {}),
    ("cosine_embedding_loss", (A, B, PM1), dict(margin=0.2)),
    ("square_error_cost", (A, B), {}), ("log_loss", (PROB, Y01), {}),
    ("sigmoid_focal_loss", (A, Y01), {}),
    ("sigmoid_focal_loss", (A, Y01, np.array([3.0], np.float32)),
     dict(reduction="mean", gamma=1.5)),
    ("npair_loss", (A, B, np.array([0, 1, 0, 2, 1, 0], np.int64)), {}),
    ("triplet_margin_loss", (A, B, arr((N, C), seed=9)), {}),
    ("triplet_margin_loss", (A, B, arr((N, C), seed=9)),
     dict(p=1.0, swap=True, reduction="sum")),
]


@pytest.mark.parametrize("name,args,kw", CASES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CASES)])
def test_loss_functional(name, args, kw):
    jkw = {k: paddle_tpu.to_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tkw = {k: pt.to_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    compare(lambda *a: getattr(JF, name)(*a, **jkw),
            lambda *a: getattr(TF, name)(*a, **tkw), args)


def _ctc_inputs():
    T, Nb, Cc, S = 7, 3, 5, 3
    lp = np.asarray(JF.log_softmax(paddle_tpu.to_tensor(
        arr((T, Nb, Cc), -2, 2, seed=10)))._data)
    labels = np.array([[1, 2, 2], [3, 1, 0], [4, 0, 0]], np.int64)
    return lp, labels, np.array([7, 5, 6], np.int64), \
        np.array([3, 2, 1], np.int64)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_ctc_loss(reduction):
    """The alpha recursion; "mean" divides by the label lengths;
    ``norm_by_times`` changes nothing (the reference takes it unused)."""
    lp, labels, il, ll = _ctc_inputs()
    for nbt in (False, True):
        compare(lambda a, b, c, d: JF.ctc_loss(a, b, c, d, 0, reduction,
                                               nbt),
                lambda a, b, c, d: TF.ctc_loss(a, b, c, d, 0, reduction,
                                               nbt), (lp, labels, il, ll))
    compare_layers(jnn.CTCLoss(reduction=reduction),
                   tnn.CTCLoss(reduction=reduction), (lp, labels, il, ll))


def test_translation_loss_label_smoothed_soft_ce():
    """The translation path's loss: ``CrossEntropyLoss(soft_label=True)``
    over ``label_smooth(one_hot(tgt, V), epsilon=0.1)``, [B, T, V]."""
    V = 11
    logits = arr((2, 4, V), -2, 2, seed=11)
    tgt = ints((2, 4), 0, V, seed=12)

    def run(pkg, F):
        def f(x, t):
            smooth = F.label_smooth(F.one_hot(t, V), epsilon=0.1)
            return pkg.nn.CrossEntropyLoss(soft_label=True)(x, smooth)

        return f

    compare(run(paddle_tpu, JF), run(pt, TF), (logits, tgt))


# (layer, constructor kwargs, inputs): every simple loss layer
LAYERS = [
    ("CrossEntropyLoss", dict(ignore_index=-100), (LOGITS, IGN)),
    ("CrossEntropyLoss", dict(soft_label=True, reduction="sum"),
     (LOGITS, SOFT)),
    ("MSELoss", {}, (A, B)), ("L1Loss", dict(reduction="none"), (A, B)),
    ("NLLLoss", {}, (LOGP, LABEL)), ("BCELoss", {}, (PROB, Y01)),
    ("BCEWithLogitsLoss", {}, (A, Y01)), ("KLDivLoss", {}, (LOGP, SOFT)),
    ("SmoothL1Loss", dict(delta=0.7), (A, B)),
    ("MarginRankingLoss", dict(margin=0.3), (A[:, 0], B[:, 0], PM1)),
    ("HingeEmbeddingLoss", {}, (A[:, 0], PM1)),
    ("CosineEmbeddingLoss", {}, (A, B, PM1)),
    ("TripletMarginLoss", dict(swap=True), (A, B, arr((N, C), seed=9))),
    ("SigmoidFocalLoss", dict(reduction="mean"), (A, Y01)),
]


def test_loss_layers():
    for name, kw, args in LAYERS:
        compare_layers(getattr(jnn, name)(**kw), getattr(tnn, name)(**kw),
                       args)
    jw, tw = paddle_tpu.to_tensor(W), pt.to_tensor(W)
    compare_layers(jnn.CrossEntropyLoss(weight=jw),
                   tnn.CrossEntropyLoss(weight=tw), (LOGITS, IGN))
    compare_layers(jnn.NLLLoss(weight=jw, reduction="sum"),
                   tnn.NLLLoss(weight=tw, reduction="sum"), (LOGP, IGN))


def test_hsigmoid_loss():
    """The default tree (6 classes, with and without bias) and a custom
    tree; weights carried, parameter gradients compared."""
    x = arr((4, 3), seed=13)
    y = np.array([0, 5, 2, 3], np.int64)
    for bias_attr in (None, False):
        jl = jnn.HSigmoidLoss(3, 6, bias_attr=bias_attr)
        tl = tnn.HSigmoidLoss(3, 6, bias_attr=bias_attr)
        assert list(tl.weight.shape) == [5, 3]
        compare_layers(jl, tl, (x, y))
    table = np.array([[0, 1, -1], [0, 2, 3], [1, 3, -1], [2, 0, 1]],
                     np.int64)
    code = np.array([[1, 0, 0], [0, 1, 1], [1, 1, 0], [0, 0, 1]], np.int64)
    jl, tl = jnn.HSigmoidLoss(3, 4, is_custom=True), \
        tnn.HSigmoidLoss(3, 4, is_custom=True)
    compare_layers(jl, tl, (x, y % 4, table, code))


def test_nce_loss_with_fixed_noise(monkeypatch):
    """The reference draws its noise from ``next_key()``: fixed here, and
    the same classes handed to the port through its ``torch.randint``."""
    Bn, dim, ncls, nneg = 5, 4, 12, 3
    x, y = arr((Bn, dim), seed=14), np.array([1, 0, 7, 11, 3], np.int64)
    key = jax.random.PRNGKey(7)
    monkeypatch.setattr(jrandom, "next_key", lambda: key)
    noise = torch.as_tensor(np.array(
        jax.random.randint(key, (Bn, nneg), 0, ncls)), dtype=torch.int64)
    draws = []

    def fixed(low, high, size, generator=None, device=None):
        assert (low, high, tuple(size)) == (0, ncls, (Bn, nneg))
        draws.append(generator)
        return noise

    for bias_attr in (None, False):
        jl = jnn.NCELoss(ncls, dim, nneg, bias_attr=bias_attr)
        tl = tnn.NCELoss(ncls, dim, nneg, bias_attr=bias_attr)
        params = carry(jl, tl)
        with monkeypatch.context() as mp:
            mp.setattr(nce_module.torch, "randint", fixed)
            compare(jl, tl, (x, y), params=params)
    # each forward drew once, from a generator and not torch's global RNG
    assert draws and all(isinstance(g, torch.Generator) for g in draws)
    drawn = tl(pt.to_tensor(x), pt.to_tensor(y))
    assert drawn.shape == [Bn, 1] and np.isfinite(drawn.numpy()).all()
