"""Shared helpers for the text datasets (counterpart of
``paddle_tpu/text/datasets/_common.py``): nothing is downloaded; a file
that is not staged raises."""
from __future__ import annotations

import os

from ...utils.download import dataset_home  # noqa: F401  (shared root)


def resolve_data_file(data_file, download, name, url):
    """Reference _check_exists_and_download analog, egress-free: the file
    must exist locally; otherwise tell the user exactly what to stage."""
    if data_file is not None:
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"{name}: data_file {data_file!r} does not exist"
            )
        return data_file
    if not download:
        raise AssertionError(
            "data_file is not set and downloading automatically is disabled"
        )
    cache = os.path.join(dataset_home(), name, os.path.basename(url))
    if os.path.exists(cache):
        return cache
    raise RuntimeError(
        f"{name}: automatic download is unavailable in this environment; "
        f"fetch {url} and pass data_file= (or place it at {cache})"
    )
