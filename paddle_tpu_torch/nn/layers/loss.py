"""Loss layers (counterparts of ``paddle_tpu/nn/layers/loss.py``): each
holds its functional's options and calls it. ``HSigmoidLoss`` and
``NCELoss`` hold parameters, in the JAX package's layout.

``HSigmoidLoss``: the hierarchical sigmoid over the default complete
binary tree (class ``c`` coded ``c + num_classes``; the weight row at path
bit ``j`` is ``(code >> (j + 1)) - 1`` and the bit ``(code >> j) & 1``), or
over the caller's ``path_table``/``path_code``; per sample ``sum(softplus(
pre) - bit * pre)`` over the path, ``pre`` clipped to [-40, 40]. Slots past
a class's path add exactly zero, as in the JAX package (upstream Paddle's
kernel adds log 2 for each; gradients agree).

``NCELoss``: noise-contrastive estimation with the uniform sampler: per
sample ``-log(o / (o + q))`` for the true class and ``-log(q / (o + q))``
for each of ``num_neg_samples`` noise classes, ``o = sigmoid(logit)``, ``q
= num_neg_samples / num_classes``. The noise classes are drawn uniformly
from ``generator`` (the package's generator of the input's device when
None) on each call; their values are not JAX's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..functional import loss as L
from ..initializer import XavierNormal
from ..layer import Layer
from ...core.random import default_generator

__all__ = [
    "CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
    "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss", "MarginRankingLoss",
    "HingeEmbeddingLoss", "CosineEmbeddingLoss", "CTCLoss",
    "TripletMarginLoss", "SigmoidFocalLoss", "HSigmoidLoss", "NCELoss",
]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__()
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction, self.soft_label = reduction, soft_label
        self.axis, self.use_softmax = axis, use_softmax

    def forward(self, input, label):
        return L.cross_entropy(
            input, label, weight=_raw(self.weight),
            ignore_index=self.ignore_index, reduction=self.reduction,
            soft_label=self.soft_label, axis=self.axis,
            use_softmax=self.use_softmax)


def _raw(t):
    """A held ``Tensor`` option (a class weight) as its torch tensor."""
    return getattr(t, "_data", t)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return L.mse_loss(input, label, self.reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return L.l1_loss(input, label, self.reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self.weight, self.ignore_index = weight, ignore_index
        self.reduction = reduction

    def forward(self, input, label):
        return L.nll_loss(input, label, _raw(self.weight), self.ignore_index,
                          self.reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction

    def forward(self, input, label):
        return L.binary_cross_entropy(input, label, _raw(self.weight),
                                      self.reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self.weight, self.reduction = weight, reduction
        self.pos_weight = pos_weight

    def forward(self, logit, label):
        return L.binary_cross_entropy_with_logits(
            logit, label, _raw(self.weight), self.reduction,
            _raw(self.pos_weight))


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return L.kl_div(input, label, self.reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self.reduction, self.delta = reduction, delta

    def forward(self, input, label):
        return L.smooth_l1_loss(input, label, self.reduction, self.delta)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, other, label):
        return L.margin_ranking_loss(input, other, label, self.margin,
                                     self.reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input, label):
        return L.hinge_embedding_loss(input, label, self.margin,
                                      self.reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0, reduction="mean", name=None):
        super().__init__()
        self.margin, self.reduction = margin, reduction

    def forward(self, input1, input2, label):
        return L.cosine_embedding_loss(input1, input2, label, self.margin,
                                       self.reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank, self.reduction = blank, reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return L.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self.margin, self.p, self.epsilon = margin, p, epsilon
        self.swap, self.reduction = swap, reduction

    def forward(self, input, positive, negative):
        return L.triplet_margin_loss(input, positive, negative, self.margin,
                                     self.p, self.epsilon, self.swap,
                                     self.reduction)


class SigmoidFocalLoss(Layer):
    def __init__(self, alpha=0.25, gamma=2.0, normalizer=None,
                 reduction="sum", name=None):
        super().__init__()
        self.alpha, self.gamma = alpha, gamma
        self.normalizer, self.reduction = normalizer, reduction

    def forward(self, logit, label):
        return L.sigmoid_focal_loss(logit, label, _raw(self.normalizer),
                                    self.alpha, self.gamma, self.reduction)


def _hsigmoid_tables(num_classes):
    """Per-class (row index, bit, mask) ``[C, L]`` tables of the default
    tree (``matrix_bit_code.h`` SimpleCode)."""
    max_len = int(np.floor(np.log2(2 * num_classes - 1)))
    idx = np.zeros((num_classes, max_len), np.int64)
    bit = np.zeros((num_classes, max_len), np.float32)
    msk = np.zeros((num_classes, max_len), np.float32)
    for c in range(num_classes):
        code = c + num_classes
        for j in range(code.bit_length() - 1):
            idx[c, j] = (code >> (j + 1)) - 1
            bit[c, j] = (code >> j) & 1
            msk[c, j] = 1.0
    return idx, bit, msk


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid (the module's notes): ``weight`` ``[C - 1,
    feature_size]`` (``[C, feature_size]`` with ``is_custom``),
    XavierNormal, and ``bias`` of as many rows, zeros (none with
    ``bias_attr=False``). ``forward`` returns ``[N, 1]``."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False, name=None,
                 *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        if num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        self.num_classes = int(num_classes)
        self.is_custom = bool(is_custom)
        rows = self.num_classes if is_custom else self.num_classes - 1
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            [rows, feature_size], weight_attr,
            default_initializer=XavierNormal(), **kw)
        self.bias = None if bias_attr is False else self.create_parameter(
            [rows], bias_attr, is_bias=True, **kw)
        self._tables = None if is_custom else _hsigmoid_tables(
            self.num_classes)

    def forward(self, input, label, path_table=None, path_code=None):
        w = self.weight
        y = label.reshape(-1).long()
        if self.is_custom:
            if path_table is None or path_code is None:
                raise ValueError("is_custom HSigmoidLoss needs path_table "
                                 "and path_code")
            tbl = path_table.long()[y]
            idx = tbl.clamp(min=0)
            bits = path_code[y].to(torch.float32)
            mask = (tbl >= 0).to(torch.float32)
        else:
            idx, bits, mask = (torch.as_tensor(t, device=w.device)[y]
                               for t in self._tables)
        pre = torch.einsum("blf,bf->bl", w[idx], input.to(w.dtype))
        if self.bias is not None:
            pre = pre + self.bias[idx]
        pre = pre.clamp(-40.0, 40.0)
        loss = (torch.nn.functional.softplus(pre) - bits * pre) * mask
        return loss.sum(dim=-1, keepdim=True)


class NCELoss(Layer):
    """Noise-contrastive estimation (the module's notes): ``weight``
    ``[num_classes, dim]`` XavierNormal, ``bias`` ``[num_classes]`` zeros
    (none with ``bias_attr=False``). ``forward(input, label)`` returns
    ``[N, 1]``; the ``[N, num_neg_samples]`` noise classes are drawn
    uniformly from ``generator`` on each call."""

    def __init__(self, num_classes, dim, num_neg_samples=10,
                 weight_attr=None, bias_attr=None, sampler="uniform",
                 name=None, *, device=None, dtype=None, generator=None):
        super().__init__(dtype=dtype)
        if sampler != "uniform":
            raise NotImplementedError(
                "NCELoss sampler: only 'uniform' (the JAX package's)")
        self.num_classes = int(num_classes)
        self.num_neg = int(num_neg_samples)
        self._generator = generator
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            [num_classes, dim], weight_attr,
            default_initializer=XavierNormal(), **kw)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_classes], bias_attr, is_bias=True, **kw)

    def forward(self, input, label):
        B = input.shape[0]
        gen = self._generator or default_generator(input.device)
        noise = torch.randint(0, self.num_classes, (B, self.num_neg),
                              generator=gen, device=input.device)
        ids = torch.cat([label.reshape(B, 1).long(), noise.long()], dim=1)
        logits = torch.einsum("bsd,bd->bs", self.weight[ids].float(),
                              input.float())
        if self.bias is not None:
            logits = logits + self.bias[ids]
        o = torch.sigmoid(logits)
        q = self.num_neg / self.num_classes
        true_cost = -torch.log(o[:, :1] / (o[:, :1] + q) + 1e-20)
        noise_cost = -torch.log(q / (o[:, 1:] + q) + 1e-20)
        return (true_cost.sum(-1) + noise_cost.sum(-1))[:, None]
