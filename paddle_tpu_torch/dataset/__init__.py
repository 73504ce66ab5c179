"""paddle.dataset — fluid-era sample-reader dataset APIs (counterpart of
``paddle_tpu/dataset``).

Reference: python/paddle/dataset/* (uci_housing.py:91 train/test, mnist,
imdb, imikolov, ...): each module exposes `train()`/`test()` returning a
READER (zero-arg callable yielding samples) that feeds `paddle.batch`.

The data itself lives in the modern map-style datasets
(``vision.datasets`` / ``text.datasets`` of the port); these adapters
re-shape them into the reader protocol so fluid-era scripts run with the
import changed. Dataset constructor kwargs (data files, paths) pass
through: ``uci_housing.train(data_file=...)``. ``conll05.test()`` builds
``Conll05st`` without a mode, which it does not take (the JAX package's
passes one and raises).
"""
from __future__ import annotations

import importlib

_TEXT = __name__.rsplit(".", 1)[0] + ".text.datasets"
_VISION = __name__.rsplit(".", 1)[0] + ".vision.datasets"

__all__ = ["uci_housing", "mnist", "imdb", "imikolov", "cifar",
           "movielens", "conll05", "wmt14", "wmt16"]


def _reader_from(dataset_cls, mode, **kwargs):
    def reader():
        ds = dataset_cls(**kwargs) if mode is None \
            else dataset_cls(mode=mode, **kwargs)
        for i in range(len(ds)):
            sample = ds[i]
            yield tuple(sample) if isinstance(sample, (list, tuple)) \
                else (sample,)

    return reader


class _ReaderModule:
    """One paddle.dataset.<name> module shape: train()/test() factories."""

    def __init__(self, loader, train_mode="train", test_mode="test"):
        self._loader = loader
        self._train_mode = train_mode
        self._test_mode = test_mode

    def train(self, **kwargs):
        return _reader_from(self._loader(), self._train_mode, **kwargs)

    def test(self, **kwargs):
        return _reader_from(self._loader(), self._test_mode, **kwargs)


def _cls(module, name):
    """The dataset class ``name`` of ``module``, imported on first use
    (``vision`` imports ``nn``, which must not import this package)."""
    return lambda: getattr(importlib.import_module(module), name)


uci_housing = _ReaderModule(_cls(_TEXT, "UCIHousing"))
imdb = _ReaderModule(_cls(_TEXT, "Imdb"))
imikolov = _ReaderModule(_cls(_TEXT, "Imikolov"))
movielens = _ReaderModule(_cls(_TEXT, "Movielens"))
# CoNLL-2005 ships its test split only, and Conll05st takes no mode (the
# JAX package passes mode="test" to it, which raises)
conll05 = _ReaderModule(_cls(_TEXT, "Conll05st"), test_mode=None)
wmt14 = _ReaderModule(_cls(_TEXT, "WMT14"))
wmt16 = _ReaderModule(_cls(_TEXT, "WMT16"))
mnist = _ReaderModule(_cls(_VISION, "MNIST"))
cifar = _ReaderModule(_cls(_VISION, "Cifar10"))
