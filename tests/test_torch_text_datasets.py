"""The port's ``text.datasets`` and ``paddle.dataset`` readers against
paddle_tpu's, on the synthetic artifacts of tests/test_text_datasets.py
(the same bytes, in the reference's on-disk formats) and the staged MNIST
and Cifar files of the vision tests: every sample of every mode equal,
value and type. Nothing is downloaded: a missing file raises in both."""
import gzip
import io
import os
import tarfile
import zipfile

import numpy as np
import pytest

import paddle_tpu
from paddle_tpu.text import datasets as jtd

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch.text import datasets as ttd
from helpers.stage_ref_data import stage_mnist
from test_text_datasets import _tar_add
from test_torch_ops_math import cpu_device  # noqa: F401
from test_torch_vision_data import _cifar_tar


def _write(tmp):
    """The artifacts of tests/test_text_datasets.py, by dataset."""
    rows = np.random.RandomState(0).rand(20, 14).astype(np.float64)
    with open(tmp / "housing.data", "w") as fh:
        for r in rows:
            fh.write(" ".join(f"{v:.6f}" for v in r) + "\n")
    with tarfile.open(tmp / "aclImdb_v1.tar.gz", "w:gz") as tf:
        for name, data in {
                "aclImdb/train/pos/0_9.txt": b"great great great movie!",
                "aclImdb/train/neg/0_1.txt": b"bad, bad film. great?",
                "aclImdb/test/pos/0_10.txt": b"great fun",
                "aclImdb/test/neg/0_2.txt": b"truly bad"}.items():
            _tar_add(tf, name, data)
    with tarfile.open(tmp / "simple-examples.tar.gz", "w:gz") as tf:
        _tar_add(tf, "./simple-examples/data/ptb.train.txt",
                 b"the cat sat\nthe dog sat\n")
        _tar_add(tf, "./simple-examples/data/ptb.valid.txt",
                 b"the cat ran\n")
    with zipfile.ZipFile(tmp / "ml-1m.zip", "w") as z:
        z.writestr("ml-1m/movies.dat",
                   "1::Toy Story (1995)::Animation|Comedy\n"
                   "2::Jumanji (1995)::Adventure\n")
        z.writestr("ml-1m/users.dat",
                   "1::M::25::10::48067\n2::F::35::3::55117\n")
        z.writestr("ml-1m/ratings.dat",
                   "1::1::5::978300760\n1::2::3::978302109\n"
                   "2::1::4::978301968\n")
    corpus = b"hello world\tbonjour monde\nhello\tbonjour\n"
    with tarfile.open(tmp / "wmt14.tgz", "w:gz") as tf:
        _tar_add(tf, "wmt14/src.dict", b"<s>\n<e>\n<unk>\nhello\nworld\n")
        _tar_add(tf, "wmt14/trg.dict", b"<s>\n<e>\n<unk>\nbonjour\nmonde\n")
        _tar_add(tf, "wmt14/train/train", corpus)
        _tar_add(tf, "wmt14/test/test", corpus[:28])
    with tarfile.open(tmp / "wmt16.tar.gz", "w:gz") as tf:
        _tar_add(tf, "wmt16/train", b"a b b\tx y\nb\ty\n")
        _tar_add(tf, "wmt16/val", b"a\tx\n")
    wbuf, pbuf = io.BytesIO(), io.BytesIO()
    with gzip.GzipFile(fileobj=wbuf, mode="w") as g:
        g.write(b"The\ncat\nsat\n\n")
    with gzip.GzipFile(fileobj=pbuf, mode="w") as g:
        g.write(b"-\t(A0*\n-\t*)\nsit\t(V*)\n\n")
    with tarfile.open(tmp / "conll05st-tests.tar.gz", "w:gz") as tf:
        _tar_add(tf, "conll05st-release/test.wsj/words/test.wsj.words.gz",
                 wbuf.getvalue())
        _tar_add(tf, "conll05st-release/test.wsj/props/test.wsj.props.gz",
                 pbuf.getvalue())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("text_datasets")
    _write(tmp)
    _cifar_tar(str(tmp / "cifar.tar.gz"), 10)
    stage_mnist(str(tmp), n_train=48, n_test=16)
    return tmp


# (dataset, file, [constructor keywords of each mode])
DATASETS = {
    "UCIHousing": ("housing.data", [dict(mode="train"), dict(mode="test")]),
    "Imdb": ("aclImdb_v1.tar.gz", [dict(mode="train", cutoff=1),
                                   dict(mode="test", cutoff=1)]),
    "Imikolov": ("simple-examples.tar.gz", [
        dict(data_type="NGRAM", window_size=2, mode="train",
             min_word_freq=1),
        dict(data_type="SEQ", mode="test", min_word_freq=1)]),
    "Movielens": ("ml-1m.zip", [dict(mode="train", test_ratio=0.0),
                                dict(mode="test", test_ratio=1.0)]),
    "WMT14": ("wmt14.tgz", [dict(mode="train", dict_size=5),
                            dict(mode="test", dict_size=5)]),
    "WMT16": ("wmt16.tar.gz", [dict(mode="train", lang="en"),
                               dict(mode="val", lang="de")]),
    "Conll05st": ("conll05st-tests.tar.gz", [{}]),
}


def _same(a, b):
    """Samples equal: arrays by value and type, lists and strings as
    they are."""
    if isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        return
    assert a == b


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_text_dataset(files, name):
    fname, modes = DATASETS[name]
    for kw in modes:
        j = getattr(jtd, name)(data_file=str(files / fname), **kw)
        t = getattr(ttd, name)(data_file=str(files / fname), **kw)
        assert len(t) == len(j) > 0
        for i in range(len(j)):
            _same(t[i], j[i])
        for attr in ("word_idx", "src_dict", "trg_dict"):
            if hasattr(j, attr):
                assert getattr(t, attr) == getattr(j, attr)


def test_missing_file_raises_as_the_reference():
    for mod in (jtd, ttd):
        with pytest.raises(FileNotFoundError):
            mod.UCIHousing(data_file="/nonexistent/housing.data")
        with pytest.raises(AssertionError, match="downloading"):
            mod.Imdb(download=False)


def test_text_namespace():
    assert set(pt.text.__all__) == set(paddle_tpu.text.__all__)
    assert pt.text.UCIHousing is ttd.UCIHousing


READERS = {
    "uci_housing": dict(data_file="housing.data"),
    "imdb": dict(data_file="aclImdb_v1.tar.gz", cutoff=1),
    "imikolov": dict(data_file="simple-examples.tar.gz", data_type="SEQ",
                     min_word_freq=1),
    "movielens": dict(data_file="ml-1m.zip", test_ratio=0.5),
    "wmt14": dict(data_file="wmt14.tgz", dict_size=5),
    "wmt16": dict(data_file="wmt16.tar.gz", lang="en"),
    "cifar": dict(data_file="cifar.tar.gz"),
    "mnist": {},
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_dataset_reader(files, name, monkeypatch):
    monkeypatch.setenv("PADDLE_DATASET_HOME", str(files))
    kw = {k: (str(files / v) if k == "data_file" else v)
          for k, v in READERS[name].items()}
    for which in ("train", "test"):
        if name == "wmt16" and which == "test":
            continue  # the artifact holds train and val only
        j = list(getattr(getattr(paddle_tpu.dataset, name), which)(**kw)())
        t = list(getattr(getattr(pt.dataset, name), which)(**kw)())
        assert len(t) == len(j) > 0
        for a, b in zip(t, j):
            _same(a, b)


def test_conll05_reader(files):
    """A named departure: the reference's reader passes ``mode="test"`` to
    ``Conll05st``, which takes none, and raises; the port's builds it
    without one and yields the dataset's samples."""
    kw = dict(data_file=str(files / "conll05st-tests.tar.gz"))
    with pytest.raises(TypeError, match="mode"):
        list(paddle_tpu.dataset.conll05.test(**kw)())
    t = list(pt.dataset.conll05.test(**kw)())
    j = jtd.Conll05st(**kw)
    assert len(t) == len(j) == 1
    _same(list(t[0]), list(j[0]))


def test_dataset_namespace():
    assert set(pt.dataset.__all__) == set(paddle_tpu.dataset.__all__)
    mnist = pt.dataset.mnist.train()
    assert callable(mnist)
    assert os.path.basename(pt.dataset.__file__) == "__init__.py"
