"""WMT16 (Multi30K) en<->de dataset (reference: text/datasets/wmt16.py —
tar with wmt16/{train,test,val} tab-separated parallel corpus; word dicts
BUILT from the train split with <s>/<e>/<unk> heading the vocab)."""
from __future__ import annotations

import tarfile
from collections import defaultdict

import numpy as np

from ...io.dataset import Dataset
from ._common import resolve_data_file

__all__ = ["WMT16"]

URL = "http://paddlemodels.bj.bcebos.com/wmt/wmt16.tar.gz"

START_MARK = "<s>"
END_MARK = "<e>"
UNK_MARK = "<unk>"


class WMT16(Dataset):
    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en", download=True):
        if mode.lower() not in ("train", "test", "val"):
            raise ValueError(
                f"mode should be 'train', 'test' or 'val', got {mode}"
            )
        if lang not in ("en", "de"):
            raise ValueError(f"lang should be 'en' or 'de', got {lang}")
        self.mode = mode.lower()
        self.lang = lang
        self.data_file = resolve_data_file(data_file, download, "wmt16", URL)
        self.src_dict = self._build_dict(src_dict_size, lang)
        self.trg_dict = self._build_dict(
            trg_dict_size, "de" if lang == "en" else "en"
        )
        self._load()

    def _build_dict(self, dict_size, lang):
        freq = defaultdict(int)
        col = 0 if lang == "en" else 1
        with tarfile.open(self.data_file) as tf:
            for line in tf.extractfile("wmt16/train"):
                parts = line.decode("utf-8", "ignore").strip().split("\t")
                if len(parts) != 2:
                    continue
                for w in parts[col].split():
                    freq[w] += 1
        words = [START_MARK, END_MARK, UNK_MARK] + [
            w for w, _ in sorted(freq.items(), key=lambda x: -x[1])
        ]
        if dict_size > 0:
            words = words[:dict_size]
        return {w: i for i, w in enumerate(words)}

    def _load(self):
        start = self.src_dict[START_MARK]
        end = self.src_dict[END_MARK]
        unk = self.src_dict[UNK_MARK]
        src_col = 0 if self.lang == "en" else 1
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file) as tf:
            for line in tf.extractfile(f"wmt16/{self.mode}"):
                parts = line.decode("utf-8", "ignore").strip().split("\t")
                if len(parts) != 2:
                    continue
                src = [start] + [
                    self.src_dict.get(w, unk)
                    for w in parts[src_col].split()
                ] + [end]
                trg = [
                    self.trg_dict.get(w, unk)
                    for w in parts[1 - src_col].split()
                ]
                self.src_ids.append(src)
                self.trg_ids_next.append(trg + [end])
                self.trg_ids.append([start] + trg)

    def __getitem__(self, idx):
        return (np.array(self.src_ids[idx]), np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __len__(self):
        return len(self.src_ids)

    def get_dict(self, lang, reverse=False):
        d = self.src_dict if lang == self.lang else self.trg_dict
        return {v: k for k, v in d.items()} if reverse else d
