"""UCI housing dataset (reference: text/datasets/uci_housing.py — parses
`housing.data` whitespace floats, per-feature (x-avg)/(max-min) scaling,
80/20 train/test split)."""
from __future__ import annotations

import numpy as np

from ...io.dataset import Dataset
from ._common import resolve_data_file

__all__ = ["UCIHousing"]

URL = "http://paddlemodels.bj.bcebos.com/uci_housing/housing.data"

feature_names = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS", "RAD", "TAX",
    "PTRATIO", "B", "LSTAT",
]


class UCIHousing(Dataset):
    def __init__(self, data_file=None, mode="train", download=True):
        if mode.lower() not in ("train", "test"):
            raise ValueError(f"mode should be 'train' or 'test', got {mode}")
        self.mode = mode.lower()
        self.data_file = resolve_data_file(
            data_file, download, "uci_housing", URL
        )
        self._load(feature_num=14, ratio=0.8)

    def _load(self, feature_num, ratio):
        raw = np.fromfile(self.data_file, sep=" ")
        raw = raw.reshape(raw.shape[0] // feature_num, feature_num)
        mx, mn = raw.max(axis=0), raw.min(axis=0)
        avg = raw.mean(axis=0)
        for i in range(feature_num - 1):
            span = mx[i] - mn[i]
            raw[:, i] = (raw[:, i] - avg[i]) / (span if span else 1.0)
        cut = int(raw.shape[0] * ratio)
        self.data = raw[:cut] if self.mode == "train" else raw[cut:]

    def __getitem__(self, idx):
        row = self.data[idx]
        return (row[:-1].astype("float32"), row[-1:].astype("float32"))

    def __len__(self):
        return len(self.data)
