"""Streaming metrics (counterpart of ``paddle_tpu/metric/__init__.py``;
reference: python/paddle/metric/metrics.py: Metric :47, Accuracy :177,
Precision :280, Recall :385, Auc :475).

``update`` and ``accumulate`` run on the host, as in the JAX package:
``update`` reads its inputs to numpy (one device-to-host read a call).
``Accuracy.compute`` runs on the inputs' device: a stable descending sort
of the scores and a comparison of the top ``maxk`` indices with the label,
which is numpy's ``argsort(-p)`` order (stable there for up to 16
classes; ties in wider rows may order differently in either package).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tensor import Tensor, to_torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return Tensor._wrap(x).numpy()
    return np.asarray(x)


def _raw(x) -> torch.Tensor:
    x = to_torch(x)
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


class Metric:
    def __init__(self):
        pass

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Optional pre-processing run on device outputs; default
        pass-through."""
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = np.zeros(len(self.topk))
        self.count = np.zeros(len(self.topk))

    def compute(self, pred, label, *args):
        """pred: (N, C) scores; label: (N,) or (N, 1) int. Returns the
        (N, maxk) bool ``Tensor`` of hits, on ``pred``'s device."""
        p = _raw(pred)
        lab = _raw(label).to(p.device).reshape(p.shape[0], -1)
        order = torch.sort(-p, dim=-1, stable=True).indices
        return Tensor._wrap(order[:, : self.maxk] == lab[:, :1])

    def update(self, correct, *args):
        correct = _np(correct)
        accs = []
        for i, k in enumerate(self.topk):
            num = correct[:, :k].sum()
            self.total[i] += num
            self.count[i] += len(correct)
            accs.append(float(num) / len(correct))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        res = [
            float(t / c) if c > 0 else 0.0
            for t, c in zip(self.total, self.count)
        ]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return float(self.tp) / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Streaming AUC via histogram buckets (metrics.py Auc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p = _np(preds)
        if p.ndim == 2 and p.shape[1] == 2:
            p = p[:, 1]
        p = p.reshape(-1)
        lab = _np(labels).reshape(-1)
        idx = (p * self.num_thresholds).astype(np.int64).clip(
            0, self.num_thresholds)
        pos_mask = lab.astype(bool)
        np.add.at(self._stat_pos, idx[pos_mask], 1)
        np.add.at(self._stat_neg, idx[~pos_mask], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        # area via trapezoid over threshold buckets (descending threshold)
        pos = np.cumsum(self._stat_pos[::-1])
        neg = np.cumsum(self._stat_neg[::-1])
        tpr = pos / tot_pos
        fpr = neg / tot_neg
        return float(np.trapezoid(tpr, fpr))

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Functional accuracy (fluid/layers/metric_op.py accuracy): a float32
    scalar ``Tensor`` on the current device."""
    p = _np(input)
    lab = _np(label).reshape(len(p), -1)
    topk = np.argsort(-p, axis=-1)[:, :k]
    acc = float((topk == lab[:, :1]).any(-1).mean())
    return Tensor(np.asarray(acc, np.float32))
