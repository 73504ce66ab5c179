"""WMT14 en->fr dataset (reference: text/datasets/wmt14.py — tarball with
{mode}/{mode} tab-separated parallel files + src.dict/trg.dict; sequences
get <s>/<e> sentinels, UNK id 2, length-80 train filter)."""
from __future__ import annotations

import tarfile

import numpy as np

from ...io.dataset import Dataset
from ._common import resolve_data_file

__all__ = ["WMT14"]

URL = "http://paddlemodels.bj.bcebos.com/wmt/wmt14.tgz"

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2


class WMT14(Dataset):
    def __init__(self, data_file=None, mode="train", dict_size=-1,
                 download=True):
        if mode.lower() not in ("train", "test", "gen"):
            raise ValueError(
                f"mode should be 'train', 'test' or 'gen', got {mode}"
            )
        self.mode = mode.lower()
        if dict_size <= 0:
            raise ValueError("dict_size should be a positive number")
        self.dict_size = dict_size
        self.data_file = resolve_data_file(data_file, download, "wmt14", URL)
        self._load()

    @staticmethod
    def _to_dict(fd, size):
        out = {}
        for i, line in enumerate(fd):
            if i >= size:
                break
            out[line.decode("utf-8", "ignore").strip()] = i
        return out

    def _load(self):
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        with tarfile.open(self.data_file) as tf:
            src_dicts = [n for n in tf.getnames() if n.endswith("src.dict")]
            trg_dicts = [n for n in tf.getnames() if n.endswith("trg.dict")]
            if len(src_dicts) != 1 or len(trg_dicts) != 1:
                raise ValueError(
                    "wmt14 archive must contain exactly one src.dict and "
                    "one trg.dict"
                )
            self.src_dict = self._to_dict(
                tf.extractfile(src_dicts[0]), self.dict_size
            )
            self.trg_dict = self._to_dict(
                tf.extractfile(trg_dicts[0]), self.dict_size
            )
            suffix = f"{self.mode}/{self.mode}"
            for name in tf.getnames():
                if not name.endswith(suffix):
                    continue
                for line in tf.extractfile(name):
                    parts = line.decode("utf-8", "ignore").strip().split(
                        "\t"
                    )
                    if len(parts) != 2:
                        continue
                    src = [
                        self.src_dict.get(w, UNK_IDX)
                        for w in [START] + parts[0].split() + [END]
                    ]
                    trg = [
                        self.trg_dict.get(w, UNK_IDX)
                        for w in parts[1].split()
                    ]
                    if len(src) > 80 or len(trg) > 80:
                        continue
                    self.src_ids.append(src)
                    self.trg_ids_next.append(trg + [self.trg_dict[END]])
                    self.trg_ids.append([self.trg_dict[START]] + trg)

    def __getitem__(self, idx):
        return (np.array(self.src_ids[idx]), np.array(self.trg_ids[idx]),
                np.array(self.trg_ids_next[idx]))

    def __len__(self):
        return len(self.src_ids)

    def get_dict(self, reverse=False):
        if reverse:
            return (
                {v: k for k, v in self.src_dict.items()},
                {v: k for k, v in self.trg_dict.items()},
            )
        return self.src_dict, self.trg_dict
