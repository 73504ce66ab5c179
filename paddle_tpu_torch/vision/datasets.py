"""Vision datasets (counterpart of ``paddle_tpu/vision/datasets.py``;
reference: python/paddle/vision/datasets/{mnist,cifar}.py). Nothing is
downloaded: MNIST and FashionMNIST read local IDX files (gzip or not,
staged under ``utils.download.dataset_home()`` or passed by path), Cifar10
and Cifar100 a local ``data_file`` tar.gz, and a missing file raises;
``FakeData`` makes deterministic samples, seeded per index. Samples are
numpy on the host.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io.dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "FakeData"]


class MNIST(Dataset):
    """IDX-format MNIST reader (reference: vision/datasets/mnist.py parses the
    same gzip IDX files). Pass image_path/label_path, or pre-stage the
    standard file names under `$PADDLE_DATASET_HOME/<_NAME>/` (the
    reference's download-cache layout) so `MNIST(mode="train")` resolves
    with no arguments — what verbatim reference scripts call.
    No downloading in this environment."""

    _NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        if image_path is None or label_path is None:
            image_path, label_path = self._default_paths(mode)
        if image_path is None or label_path is None:
            from ..utils.download import dataset_home

            raise ValueError(
                f"{type(self).__name__} requires local image_path/"
                "label_path (no network in this environment); stage the "
                f"IDX files under {os.path.join(dataset_home(), self._NAME)}"
                " or use paddle_tpu_torch.vision.datasets.FakeData"
            )
        self.images = self._parse_images(image_path)
        self.labels = self._parse_labels(label_path)

    @classmethod
    def _default_paths(cls, mode):
        from ..utils.download import dataset_home

        prefix = "train" if mode == "train" else "t10k"
        root = os.path.join(dataset_home(), cls._NAME)
        img = lbl = None
        for ext in (".gz", ""):
            p = os.path.join(root, f"{prefix}-images-idx3-ubyte{ext}")
            q = os.path.join(root, f"{prefix}-labels-idx1-ubyte{ext}")
            if img is None and os.path.exists(p):
                img = p
            if lbl is None and os.path.exists(q):
                lbl = q
        return img, lbl

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")

    def _parse_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(n, 1, rows, cols).astype(np.float32) / 255.0

    def _parse_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.astype(np.int64)

    def __getitem__(self, idx):
        img, lbl = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, lbl

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    _NAME = "fashion-mnist"


class _CifarBase(Dataset):
    _n_classes = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if data_file is None:
            raise ValueError(
                "Cifar requires a local data_file (no network); use FakeData "
                "for synthetic samples"
            )
        import pickle
        import tarfile

        self.transform = transform
        images, labels = [], []
        with tarfile.open(data_file, "r:gz") as tf:
            names = [
                m
                for m in tf.getmembers()
                if ("data_batch" in m.name if mode == "train" else "test_batch" in m.name)
            ]
            for m in sorted(names, key=lambda m: m.name):
                d = pickle.load(tf.extractfile(m), encoding="bytes")
                images.append(d[b"data"])
                key = b"labels" if b"labels" in d else b"fine_labels"
                labels.extend(d[key])
        self.images = (
            np.concatenate(images).reshape(-1, 3, 32, 32).astype(np.float32) / 255.0
        )
        self.labels = np.asarray(labels, np.int64)

    def __getitem__(self, idx):
        img, lbl = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, lbl

    def __len__(self):
        return len(self.images)


class Cifar10(_CifarBase):
    pass


class Cifar100(_CifarBase):
    _n_classes = 100


class FakeData(Dataset):
    """Deterministic synthetic dataset for tests/benchmarks (shape-compatible
    with MNIST/ImageNet-style loaders)."""

    def __init__(self, sample_shape=(1, 28, 28), num_samples=1024,
                 num_classes=10, transform=None, seed=0):
        self.shape = tuple(sample_shape)
        self.n = num_samples
        self.num_classes = num_classes
        self.transform = transform
        self.seed = seed

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        img = 0.2 * rng.rand(*self.shape).astype(np.float32)
        lbl = np.int64(idx % self.num_classes)
        # inject a strong class-dependent stripe so tiny models learn fast
        w = self.shape[-1]
        col = (int(lbl) * w) // self.num_classes
        band = max(w // self.num_classes, 1)
        img[..., :, col : col + band] += 1.0
        if self.transform is not None:
            img = self.transform(img)
        return img, lbl

    def __len__(self):
        return self.n
