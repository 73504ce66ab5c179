"""Dataset staging paths (counterpart of ``paddle_tpu/utils/download.py``),
with no download.

Upstream Paddle downloads datasets into ``~/.cache/paddle/dataset/<name>/``.
The port downloads nothing: the same layout is a staging directory.
Loaders in ``vision`` resolve their default file paths under it, and a
file that is not staged there raises.
"""
from __future__ import annotations

import os

__all__ = ["dataset_home", "get_path_from_url"]


def dataset_home() -> str:
    """Root of the staged dataset files; ``PADDLE_DATASET_HOME``
    overrides the default cache directory."""
    return os.environ.get(
        "PADDLE_DATASET_HOME",
        os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu",
                     "dataset"),
    )


def get_path_from_url(url: str, root_dir: str | None = None, **kw) -> str:
    """Where ``url``'s file would be cached; raises unless it is staged
    there."""
    path = os.path.join(root_dir or dataset_home(), os.path.basename(url))
    if not os.path.exists(path):
        raise RuntimeError(
            f"automatic download is unavailable in this environment; "
            f"fetch {url} and place it at {path}"
        )
    return path
