"""MovieLens-1M dataset (reference: text/datasets/movielens.py — ml-1m
zip: movies.dat/users.dat/ratings.dat with '::' separators; sample =
(user fields, movie fields, title ids, category one-hot, rating) with a
seeded random train/test split)."""
from __future__ import annotations

import random
import re
import zipfile

import numpy as np

from ...io.dataset import Dataset
from ._common import resolve_data_file

__all__ = ["Movielens"]

URL = "https://dataset.bj.bcebos.com/movielens%2Fml-1m.zip"

age_table = [1, 18, 25, 35, 45, 50, 56]


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self, categories_dict, movie_title_dict):
        return [
            [self.index],
            [categories_dict[c] for c in self.categories],
            [movie_title_dict[w.lower()] for w in self.title.split()],
        ]


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == "M"
        self.age = age_table.index(int(age))
        self.job_id = int(job_id)

    def value(self):
        return [[self.index], [0 if self.is_male else 1], [self.age],
                [self.job_id]]


class Movielens(Dataset):
    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, download=True):
        if mode.lower() not in ("train", "test"):
            raise ValueError(f"mode should be 'train' or 'test', got {mode}")
        self.mode = mode.lower()
        self.test_ratio = test_ratio
        self.rand_seed = rand_seed
        self.data_file = resolve_data_file(
            data_file, download, "movielens", URL
        )
        self._load_meta()
        self._load_data()

    def _load_meta(self):
        pattern = re.compile(r"^(.*)\((\d{4})\)$")
        self.movie_info, self.movie_title_dict = {}, {}
        self.categories_dict, self.user_info = {}, {}
        with zipfile.ZipFile(self.data_file) as z:
            with z.open("ml-1m/movies.dat") as f:
                for line in f:
                    line = line.decode("latin1").strip()
                    movie_id, title, categories = line.split("::")
                    categories = categories.split("|")
                    m = pattern.match(title)
                    title = m.group(1).strip() if m else title
                    self.movie_info[int(movie_id)] = MovieInfo(
                        movie_id, categories, title
                    )
                    for c in categories:
                        self.categories_dict.setdefault(
                            c, len(self.categories_dict)
                        )
                    for w in title.split():
                        self.movie_title_dict.setdefault(
                            w.lower(), len(self.movie_title_dict)
                        )
            with z.open("ml-1m/users.dat") as f:
                for line in f:
                    line = line.decode("latin1").strip()
                    uid, gender, age, job, _ = line.split("::")
                    self.user_info[int(uid)] = UserInfo(
                        uid, gender, age, job
                    )

    def _load_data(self):
        self.data = []
        is_test = self.mode == "test"
        rng = random.Random(self.rand_seed)
        with zipfile.ZipFile(self.data_file) as z:
            with z.open("ml-1m/ratings.dat") as f:
                for line in f:
                    line = line.decode("latin1").strip()
                    uid, mid, rating, _ = line.split("::")
                    if (rng.random() < self.test_ratio) == is_test:
                        usr = self.user_info[int(uid)]
                        mov = self.movie_info[int(mid)]
                        self.data.append(
                            usr.value()
                            + mov.value(self.categories_dict,
                                        self.movie_title_dict)
                            + [[float(rating)]]
                        )

    def __getitem__(self, idx):
        return tuple(np.array(v) for v in self.data[idx])

    def __len__(self):
        return len(self.data)
