"""IMDB sentiment dataset (reference: text/datasets/imdb.py — aclImdb
tarball; vocabulary from train docs over a frequency cutoff, punctuation
stripped, label 0=pos 1=neg per the reference's ordering)."""
from __future__ import annotations

import re
import string
import tarfile

import numpy as np

from ...io.dataset import Dataset
from ._common import resolve_data_file

__all__ = ["Imdb"]

URL = "https://dataset.bj.bcebos.com/imdb%2FaclImdb_v1.tar.gz"


class Imdb(Dataset):
    def __init__(self, data_file=None, mode="train", cutoff=150,
                 download=True):
        if mode.lower() not in ("train", "test"):
            raise ValueError(f"mode should be 'train' or 'test', got {mode}")
        self.mode = mode.lower()
        self.data_file = resolve_data_file(data_file, download, "imdb", URL)
        # ONE archive walk collects the dict corpus (train pos+neg only —
        # the reference vocabulary) and this mode's documents together
        groups = self._tokenize_groups({
            "dict_pos": re.compile(r"aclImdb/train/pos/.*\.txt$"),
            "dict_neg": re.compile(r"aclImdb/train/neg/.*\.txt$"),
            "pos": re.compile(rf"aclImdb/{self.mode}/pos/.*\.txt$"),
            "neg": re.compile(rf"aclImdb/{self.mode}/neg/.*\.txt$"),
        })
        self.word_idx = self._build_dict(
            groups["dict_pos"] + groups["dict_neg"], cutoff
        )
        self._load(groups["pos"], groups["neg"])

    def _tokenize_groups(self, patterns):
        groups = {k: [] for k in patterns}
        punct = str.maketrans("", "", string.punctuation)
        with tarfile.open(self.data_file) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                doc = None
                for key, pattern in patterns.items():
                    if pattern.match(member.name):
                        if doc is None:
                            text = tf.extractfile(member).read().decode(
                                "utf-8", "ignore"
                            )
                            doc = text.rstrip("\n\r").translate(
                                punct
                            ).lower().split()
                        groups[key].append(doc)
        return groups

    @staticmethod
    def _build_dict(docs, cutoff):
        freq = {}
        for doc in docs:
            for w in doc:
                freq[w] = freq.get(w, 0) + 1
        kept = [(w, c) for w, c in freq.items() if c > cutoff]
        kept.sort(key=lambda x: (-x[1], x[0]))
        word_idx = {w: i for i, (w, _) in enumerate(kept)}
        word_idx["<unk>"] = len(word_idx)
        return word_idx

    def _load(self, pos_docs, neg_docs):
        unk = self.word_idx["<unk>"]
        self.docs, self.labels = [], []
        for label, docs in ((0, pos_docs), (1, neg_docs)):
            for doc in docs:
                self.docs.append([self.word_idx.get(w, unk) for w in doc])
                self.labels.append(label)

    def __getitem__(self, idx):
        return np.array(self.docs[idx]), np.array([self.labels[idx]])

    def __len__(self):
        return len(self.docs)
