"""``io`` of the port: Dataset, Sampler, DataLoader (counterpart of
``paddle_tpu/io/__init__.py``; reference: python/paddle/fluid/dataloader/
and python/paddle/fluid/reader.py:149 DataLoader).

Batches are collated to numpy on worker threads or processes (through the
native staging library) and reach the device once per batch, through a
pinned buffer (``dataloader.py``).
"""
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)
from .dataloader import DataLoader, default_collate_fn, vision_collate_fn

__all__ = ["ChainDataset", "ComposeDataset", "ConcatDataset", "Dataset",
           "IterableDataset", "Subset", "TensorDataset", "random_split",
           "BatchSampler", "DistributedBatchSampler", "RandomSampler",
           "Sampler", "SequenceSampler", "SubsetRandomSampler",
           "WeightedRandomSampler", "DataLoader", "default_collate_fn",
           "vision_collate_fn"]
