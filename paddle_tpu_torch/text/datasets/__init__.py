"""paddle.text.datasets of the port (counterpart of
``paddle_tpu/text/datasets``; reference: python/paddle/text/datasets/).
The parsers are numpy-only and the same as the JAX package's.

Each dataset consumes the SAME on-disk artifact format as the reference
(housing.data floats, aclImdb tar, PTB simple-examples tar, ml-1m zip,
WMT tarballs, CoNLL05 gzipped column files), passed via `data_file`.
Auto-download (download=True with data_file=None) raises with the
artifact URL — the port downloads nothing, and silently
fabricating data would be worse than asking the user to stage the file.
"""
from .uci_housing import UCIHousing  # noqa: F401
from .imdb import Imdb  # noqa: F401
from .imikolov import Imikolov  # noqa: F401
from .movielens import Movielens  # noqa: F401
from .wmt14 import WMT14  # noqa: F401
from .wmt16 import WMT16  # noqa: F401
from .conll05 import Conll05st  # noqa: F401

__all__ = [
    "UCIHousing", "Imdb", "Imikolov", "Movielens", "WMT14", "WMT16",
    "Conll05st",
]
