"""The port's ``metric``, ``vision.transforms``, ``vision.datasets`` and
the VGG and MobileNet models against paddle_tpu's.

- Metrics: the same scores and labels (numpy, seeded) through both
  packages' ``compute`` / ``update`` / ``accumulate``; counts and
  accuracies exactly, AUC within 1e-12 (the same float64 sums).
- Transforms: every name of ``transforms.__all__`` on the same CHW image
  under the same ``np.random.seed`` (both draw from the global stream),
  four calls each, outputs bit for bit (the same numpy operations).
- Datasets: MNIST from ``tests/helpers/stage_ref_data.py``'s IDX files
  (gzip, and uncompressed as FashionMNIST), Cifar10/100 from a tar.gz
  written here, ``FakeData``: every sample equal.
- Models: VGG-11 (batch norm) at 224 x 224 and MobileNet V1/V2 at 64 x 64,
  a ``paddle_tpu`` ``state_dict()`` as numpy loaded by ``set_state_dict``,
  eval-mode logits within rtol = atol = 1e-5 of the largest (float32,
  summation order across libraries).
"""
import io as _io
import os
import pickle
import struct
import sys
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import metric as jmetric
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.ops import pallas as jax_pallas
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa
from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as JT

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch import metric as pmetric
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm
from paddle_tpu_torch.vision import datasets as pds
from paddle_tpu_torch.vision import transforms as PT

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers.stage_ref_data import stage_mnist  # noqa: E402


def _fresh_process_state():
    jax_comm._state.hybrid_mesh = pt_comm._mesh = None
    jax_pallas.flash_attention = jax_fa


@pytest.fixture(autouse=True, scope="module")
def cpu_device():
    """The port's default device is the CPU here (restored after); the
    module starts and ends in a fresh process's state."""
    saved = pt_device._current
    pt.set_device("cpu")
    _fresh_process_state()
    yield
    pt_device._current = saved
    _fresh_process_state()


# -- metrics ---------------------------------------------------------------


def _scores(n=24, c=10, seed=0):
    rng = np.random.RandomState(seed)
    p = rng.rand(n, c).astype(np.float32)
    p[::5, 2] = p[::5, 7]  # ties: both packages keep the lower index
    return p, rng.randint(0, c, (n, 1)).astype(np.int64)


@pytest.mark.parametrize("topk", [(1,), (1, 3)])
def test_accuracy_equals_the_reference(topk):
    accs = {}
    for name, pkg, M in (("jax", paddle_tpu, jmetric), ("port", pt, pmetric)):
        m = M.Accuracy(topk=topk)
        steps = []
        for seed in (0, 1):
            p, lab = _scores(seed=seed)
            correct = m.compute(pkg.to_tensor(p), pkg.to_tensor(lab))
            steps.append(m.update(correct))
        hits = correct.numpy() if hasattr(correct, "numpy") else correct
        accs[name] = (np.asarray(hits), steps, m.accumulate(), m.name())
        m.reset()
        assert m.accumulate() == (0.0 if len(topk) == 1 else [0.0, 0.0])
    assert np.array_equal(*[a[0] for a in accs.values()])
    assert accs["jax"][1:] == accs["port"][1:]
    assert isinstance(accs["port"][2], (float, list))


def test_accuracy_compute_runs_on_the_scores_device():
    p, lab = _scores()
    out = pmetric.Accuracy(topk=(1, 5)).compute(pt.to_tensor(p),
                                                pt.to_tensor(lab[:, 0]))
    assert isinstance(out, pt.Tensor) and out.shape == [24, 5]
    assert out.place == pt.to_tensor(p).place


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc"])
def test_binary_metrics_equal_the_reference(name):
    rng = np.random.RandomState(3)
    out = []
    for M in (jmetric, pmetric):
        m = getattr(M, name)()
        for _ in range(3):
            preds = rng.rand(32, 2 if name == "Auc" else 1).astype(np.float32)
            labels = rng.randint(0, 2, (32, 1)).astype(np.int64)
            m.update(preds, labels)
        rng = np.random.RandomState(3)
        out.append((m.accumulate(), m.name()))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=0, atol=1e-12)
    assert out[0][1] == out[1][1]


def test_functional_accuracy_equals_the_reference():
    p, lab = _scores()
    for k in (1, 2):
        got = pmetric.accuracy(pt.to_tensor(p), pt.to_tensor(lab), k=k)
        want = jmetric.accuracy(paddle_tpu.to_tensor(p),
                                paddle_tpu.to_tensor(lab), k=k)
        assert isinstance(got, pt.Tensor) and got.dtype == torch.float32
        assert float(got.numpy()) == float(want.numpy())


# -- transforms ------------------------------------------------------------

_CHW = np.random.RandomState(5).rand(3, 40, 48).astype(np.float32)
_HWC_U8 = (np.random.RandomState(6).rand(40, 48, 3) * 255).astype(np.uint8)

TRANSFORMS = {
    "Compose": (lambda T: T.Compose([T.RandomCrop(32, padding=2),
                                     T.RandomHorizontalFlip(),
                                     T.Normalize([0.5] * 3, [0.25] * 3)]),
                _CHW),
    "ToTensor": (lambda T: T.ToTensor(), _HWC_U8),
    "ToTensor_gray": (lambda T: T.ToTensor(), _HWC_U8[..., 0]),
    "Normalize": (lambda T: T.Normalize([0.1, 0.2, 0.3], [0.5, 0.4, 0.3]),
                  _CHW),
    "Resize": (lambda T: T.Resize((20, 30)), _CHW),
    "CenterCrop": (lambda T: T.CenterCrop(24), _CHW),
    "RandomCrop": (lambda T: T.RandomCrop((24, 30), padding=2), _CHW),
    "RandomHorizontalFlip": (lambda T: T.RandomHorizontalFlip(), _CHW),
    "RandomVerticalFlip": (lambda T: T.RandomVerticalFlip(), _CHW),
    "Transpose": (lambda T: T.Transpose(), _HWC_U8),
    "Pad": (lambda T: T.Pad((2, 3)), _CHW),
    "RandomResizedCrop": (lambda T: T.RandomResizedCrop(32), _CHW),
    "BrightnessTransform": (lambda T: T.BrightnessTransform(0.4), _CHW),
    "Grayscale": (lambda T: T.Grayscale(3), _CHW),
    "ContrastTransform": (lambda T: T.ContrastTransform(0.4), _CHW),
    "SaturationTransform": (lambda T: T.SaturationTransform(0.4), _CHW),
    "HueTransform": (lambda T: T.HueTransform(0.2), _CHW),
    "ColorJitter": (lambda T: T.ColorJitter(0.4, 0.4, 0.4, 0.1), _CHW),
    "RandomRotation": (lambda T: T.RandomRotation(30), _CHW),
    "RandomRotation_bilinear_expand": (lambda T: T.RandomRotation(
        (10, 40), interpolation="bilinear", expand=True, fill=0.5), _CHW),
}


def test_every_transform_is_covered():
    names = {k.split("_")[0] for k in TRANSFORMS}
    assert set(JT.__all__) == set(PT.__all__) == names


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_equals_the_reference(name):
    make, img = TRANSFORMS[name]
    out = []
    for T in (JT, PT):
        t = make(T)
        np.random.seed(8)
        out.append([np.asarray(t(img.copy())) for _ in range(4)])
    for a, b in zip(*out):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    if name == "HueTransform":
        with pytest.raises(ValueError):
            PT.HueTransform(0.7)


# -- datasets --------------------------------------------------------------


def _write_idx(root, prefix, imgs, labels):
    with open(os.path.join(root, f"{prefix}-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, *imgs.shape) + imgs.tobytes())
    with open(os.path.join(root, f"{prefix}-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + labels.tobytes())


def _same_dataset(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        for x, y in zip(a[i], b[i]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_mnist_from_the_staged_files(tmp_path, monkeypatch):
    stage_mnist(str(tmp_path), n_train=64, n_test=32)
    rng = np.random.RandomState(2)
    os.makedirs(tmp_path / "fashion-mnist")
    _write_idx(tmp_path / "fashion-mnist", "t10k",
               rng.randint(0, 256, (16, 28, 28)).astype(np.uint8),
               rng.randint(0, 10, 16).astype(np.uint8))
    monkeypatch.setenv("PADDLE_DATASET_HOME", str(tmp_path))
    for mode in ("train", "test"):
        _same_dataset(pds.MNIST(mode=mode), jds.MNIST(mode=mode))
    _same_dataset(pds.FashionMNIST(mode="test"),
                  jds.FashionMNIST(mode="test"))
    flip = PT.RandomHorizontalFlip(1.0)
    got = pds.MNIST(mode="train", transform=flip)[3][0]
    assert np.array_equal(got, pds.MNIST(mode="train")[3][0][..., ::-1])
    for D in (pds.FashionMNIST, jds.FashionMNIST):
        with pytest.raises(ValueError, match="fashion-mnist"):
            D(mode="train")


def _cifar_tar(path, n_classes):
    rng = np.random.RandomState(n_classes)
    key = b"labels" if n_classes == 10 else b"fine_labels"
    with tarfile.open(path, "w:gz") as tf:
        for name, n in (("cifar/data_batch_2", 6), ("cifar/data_batch_1", 5),
                        ("cifar/test_batch", 4)):
            blob = pickle.dumps({
                b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                key: rng.randint(0, n_classes, n).tolist()})
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, _io.BytesIO(blob))


@pytest.mark.parametrize("name", ["Cifar10", "Cifar100"])
def test_cifar_from_a_local_archive(tmp_path, name):
    path = str(tmp_path / "cifar.tar.gz")
    _cifar_tar(path, 10 if name == "Cifar10" else 100)
    for mode in ("train", "test"):
        got = getattr(pds, name)(data_file=path, mode=mode)
        _same_dataset(got, getattr(jds, name)(data_file=path, mode=mode))
    assert len(got) == 4 and len(getattr(pds, name)(data_file=path)) == 11
    with pytest.raises(ValueError):
        getattr(pds, name)()


def test_fake_data_equals_the_reference():
    kw = dict(sample_shape=(3, 16, 20), num_samples=12, num_classes=4,
              seed=3)
    _same_dataset(pds.FakeData(**kw), jds.FakeData(**kw))
    t = pds.FakeData(transform=PT.Normalize(0.5, 0.5), **kw)
    assert np.array_equal(t[5][0], (pds.FakeData(**kw)[5][0] - 0.5) / 0.5)


# -- models ----------------------------------------------------------------

MODELS = {
    "vgg11": (dict(batch_norm=True, num_classes=10), (1, 3, 224, 224)),
    "mobilenet_v1": (dict(num_classes=10), (2, 3, 64, 64)),
    "mobilenet_v2": (dict(num_classes=10), (2, 3, 64, 64)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_forward_with_the_weights_carried(name):
    kw, shape = MODELS[name]
    paddle_tpu.seed(0)
    ref = getattr(paddle_tpu.vision.models, name)(**kw)
    ref.eval()
    port = getattr(pt.vision.models, name)(**kw)
    port.eval()
    state = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    assert port.set_state_dict(state) == ([], [])
    x = np.random.RandomState(1).rand(*shape).astype(np.float32)
    want = np.asarray(ref(paddle_tpu.to_tensor(x)).numpy())
    got = port(pt.to_tensor(x)).numpy()
    assert got.shape == want.shape == (shape[0], 10)
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)
    with pytest.raises(NotImplementedError, match="downloads nothing"):
        getattr(pt.vision.models, name)(pretrained=True)
