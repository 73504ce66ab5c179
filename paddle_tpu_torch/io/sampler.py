"""Samplers (counterpart of ``paddle_tpu/io/sampler.py``; reference:
python/paddle/fluid/dataloader/batch_sampler.py, sampler.py).

The random samplers draw from the global numpy stream, as the JAX
package's do, so ``np.random.seed(s)`` gives both packages the same order.
Departure: ``RandomSampler(generator=)`` draws from ``generator`` (a
``numpy.random.RandomState``) when one is given; the JAX package takes it
and ignores it. ``DistributedBatchSampler``'s ``num_replicas`` and
``rank`` default to the port's one-process world (1 and 0;
``distributed.comm``)."""
from __future__ import annotations

import math

import numpy as np

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "SubsetRandomSampler", "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler"]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        rng = np.random if self.generator is None else self.generator
        n = len(self.data_source)
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        super().__init__()
        self.indices = list(indices)

    def __iter__(self):
        return iter(np.random.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        super().__init__()
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(
            np.random.choice(
                len(self.weights), self.num_samples, self.replacement, p
            ).tolist()
        )

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """reference: batch_sampler.py:20."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        self.batch_size = int(batch_size)
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards sample indices across data-parallel ranks (reference:
    paddle.io DistributedBatchSampler): each rank takes every
    ``num_replicas``-th index of the (padded, per-epoch shuffled) order."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed import comm

        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.nranks = (num_replicas if num_replicas is not None
                       else comm.get_world_size())
        self.local_rank = rank if rank is not None else comm.get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(self.dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        # pad to be divisible
        indices += indices[: (self.total_size - n)]
        # subsample this rank
        indices = indices[self.local_rank: self.total_size: self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
