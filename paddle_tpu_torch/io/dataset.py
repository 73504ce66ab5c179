"""Datasets (counterpart of ``paddle_tpu/io/dataset.py``; reference:
python/paddle/fluid/dataloader/dataset.py).

Departure: ``random_split(generator=)`` draws from ``generator`` (a
``numpy.random.RandomState``) when one is given; the JAX package takes it
and ignores it. With none, both draw from the global numpy stream, so
``np.random.seed(s)`` gives both packages the same split."""
from __future__ import annotations

import bisect
from typing import List, Sequence

import numpy as np

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    """Map-style dataset (dataset.py:30)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    """Stream-style dataset (dataset.py:71)."""

    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    """Rows of equal-length tensors or arrays, kept as numpy on the
    host."""

    def __init__(self, tensors: Sequence):
        from ..core.tensor import Tensor

        self.tensors = [
            t.numpy() if isinstance(t, Tensor) else np.asarray(t)
            for t in tensors
        ]
        n = len(self.tensors[0])
        if any(len(t) != n for t in self.tensors):
            raise ValueError("all tensors must share dim 0")

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    """Zip datasets column-wise (dataset.py ComposeDataset)."""

    def __init__(self, datasets: List[Dataset]):
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        if any(len(d) != n for d in self.datasets):
            raise ValueError("all datasets must have the same length")

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            if isinstance(item, tuple):
                out.extend(item)
            else:
                out.append(item)
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets: List[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets: List[Dataset]):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = self.cumulative_sizes[ds_idx - 1] if ds_idx > 0 else 0
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence[int], generator=None):
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths must equal dataset length")
    rng = np.random if generator is None else generator
    perm = rng.permutation(len(dataset))
    out = []
    off = 0
    for n in lengths:
        out.append(Subset(dataset, perm[off: off + n].tolist()))
        off += n
    return out
