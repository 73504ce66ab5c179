"""Imikolov / PTB language-model dataset (reference:
text/datasets/imikolov.py — simple-examples tarball; vocab over
train+valid with <s>/<e> sentinels and min-frequency cutoff; NGRAM or
SEQ sample shapes)."""
from __future__ import annotations

import tarfile

import numpy as np

from ...io.dataset import Dataset
from ._common import resolve_data_file

__all__ = ["Imikolov"]

URL = "https://dataset.bj.bcebos.com/imikolov%2Fsimple-examples.tar.gz"

_TRAIN = "./simple-examples/data/ptb.train.txt"
_VALID = "./simple-examples/data/ptb.valid.txt"


class Imikolov(Dataset):
    def __init__(self, data_file=None, data_type="NGRAM", window_size=-1,
                 mode="train", min_word_freq=50, download=True):
        if data_type.upper() not in ("NGRAM", "SEQ"):
            raise ValueError(
                f"data_type should be 'NGRAM' or 'SEQ', got {data_type}"
            )
        self.data_type = data_type.upper()
        if mode.lower() not in ("train", "test"):
            raise ValueError(f"mode should be 'train' or 'test', got {mode}")
        self.mode = mode.lower()
        self.window_size = window_size
        self.data_file = resolve_data_file(
            data_file, download, "imikolov", URL
        )
        self.word_idx = self._build_dict(min_word_freq)
        self._load()

    @staticmethod
    def _count(f, freq):
        for line in f:
            for w in line.decode("utf-8", "ignore").strip().split():
                freq[w] = freq.get(w, 0) + 1
            freq["<s>"] = freq.get("<s>", 0) + 1
            freq["<e>"] = freq.get("<e>", 0) + 1
        return freq

    def _member(self, tf, path):
        try:
            return tf.extractfile(path)
        except KeyError:
            return tf.extractfile(path.lstrip("./"))

    def _build_dict(self, cutoff):
        with tarfile.open(self.data_file) as tf:
            freq = self._count(self._member(tf, _TRAIN), {})
            freq = self._count(self._member(tf, _VALID), freq)
        freq.pop("<unk>", None)
        kept = [(w, c) for w, c in freq.items() if c > cutoff]
        kept.sort(key=lambda x: (-x[1], x[0]))
        word_idx = {w: i for i, (w, _) in enumerate(kept)}
        word_idx["<unk>"] = len(word_idx)
        return word_idx

    def _load(self):
        path = _TRAIN if self.mode == "train" else _VALID
        unk = self.word_idx["<unk>"]
        self.data = []
        with tarfile.open(self.data_file) as tf:
            for line in self._member(tf, path):
                words = line.decode("utf-8", "ignore").strip().split()
                ids = (
                    [self.word_idx["<s>"]]
                    + [self.word_idx.get(w, unk) for w in words]
                    + [self.word_idx["<e>"]]
                )
                if self.data_type == "SEQ":
                    self.data.append(ids)
                else:
                    if self.window_size <= 0:
                        raise ValueError(
                            "NGRAM data_type needs window_size > 0"
                        )
                    for i in range(len(ids) - self.window_size + 1):
                        self.data.append(ids[i:i + self.window_size])

    def __getitem__(self, idx):
        return tuple(np.array([v]) for v in self.data[idx]) \
            if self.data_type == "NGRAM" else np.array(self.data[idx])

    def __len__(self):
        return len(self.data)
