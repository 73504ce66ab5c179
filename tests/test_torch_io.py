"""The port's ``io`` (datasets, samplers, DataLoader), its native staging
library, ``reader`` and ``batch`` against paddle_tpu's.

Both packages get the same numpy data. The samplers, ``random_split`` and
``reader.shuffle`` draw from the global numpy (or Python) stream in both
packages, so each comparison seeds it before each package's run and
expects the same order. DataLoader batches are compared exactly (they are
copies of the same numpy data): the port's sync, thread and process paths
against the JAX package's sync path. The process path spawns one pool of
two workers (the only spawn in this file: each worker imports torch). The
native library's outputs are held bit for bit against the JAX package's
library (the same source and flags, built by each package) and against
numpy, on this host's g++.
"""
import os
import random

import numpy as np
import pytest
import torch

import paddle_tpu
from paddle_tpu import io as jio
from paddle_tpu import native as jnative
from paddle_tpu import reader as jreader
from paddle_tpu.distributed import comm as jax_comm
from paddle_tpu.ops import pallas as jax_pallas
from paddle_tpu.ops.pallas.flash_attention import flash_attention as jax_fa

from helpers.torch_threads import one_torch_thread  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import native as pnative
from paddle_tpu_torch import reader as preader
from paddle_tpu_torch.core import device as pt_device
from paddle_tpu_torch.distributed import comm as pt_comm
from paddle_tpu_torch.io import dataloader as pdl


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


def host(obj):
    """A batch of either package as numpy (tuples, lists, dicts kept)."""
    if isinstance(obj, (paddle_tpu.Tensor, pt.Tensor)):
        return np.asarray(obj.numpy())
    if isinstance(obj, (list, tuple)):
        return type(obj)(host(o) for o in obj)
    if isinstance(obj, dict):
        return {k: host(v) for k, v in obj.items()}
    return obj


def assert_same(a, b):
    """Equal structure, types and values (numpy leaves exactly)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.shape == b.shape
        assert np.array_equal(a, b)
    else:
        assert a == b


# -- samplers and datasets -------------------------------------------------

SAMPLERS = {
    "sequence": lambda io, ds: io.SequenceSampler(ds),
    "random": lambda io, ds: io.RandomSampler(ds),
    "random_replacement": lambda io, ds: io.RandomSampler(
        ds, replacement=True, num_samples=7),
    "subset_random": lambda io, ds: io.SubsetRandomSampler(
        [3, 1, 4, 1, 5, 9, 2, 6]),
    "weighted": lambda io, ds: io.WeightedRandomSampler(
        np.arange(1, 11), 12),
    "batch_shuffle": lambda io, ds: io.BatchSampler(
        ds, shuffle=True, batch_size=3),
    "batch_drop_last": lambda io, ds: io.BatchSampler(
        ds, batch_size=3, drop_last=True),
    "distributed": lambda io, ds: io.DistributedBatchSampler(
        ds, 3, num_replicas=2, rank=1, shuffle=True),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_order_under_the_same_seed(name):
    out = []
    for io in (jio, pio):
        ds = list(range(10))
        s = SAMPLERS[name](io, ds)
        np.random.seed(5)
        out.append((list(iter(s)), list(iter(s)), len(s)))
    assert out[0] == out[1]


def test_random_split_and_the_generator_departure():
    """Under one global seed both packages split alike; given a
    ``RandomState`` the port draws from it (the JAX package ignores it:
    the named departure)."""
    ds = list(range(10))
    splits = []
    for io in (jio, pio):
        np.random.seed(2)
        splits.append([s.indices for s in io.random_split(ds, [4, 6])])
    assert splits[0] == splits[1]
    perm = np.random.RandomState(7).permutation(10).tolist()
    got = pio.random_split(ds, [4, 6], generator=np.random.RandomState(7))
    assert got[0].indices + got[1].indices == perm
    assert list(pio.RandomSampler(
        ds, generator=np.random.RandomState(7))) == perm
    np.random.seed(2)
    ref = jio.random_split(ds, [4, 6], generator=np.random.RandomState(7))
    assert [s.indices for s in ref] == splits[0]  # ignored
    with pytest.raises(ValueError):
        pio.random_split(ds, [4, 5])


def test_distributed_sampler_defaults_to_the_one_process_world(monkeypatch):
    """The one-process world by default; a launched trainer's rank and
    world size (``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``) shard the
    indices as the JAX package's sampler does."""
    ds = list(range(10))
    s = pio.DistributedBatchSampler(ds, 4, shuffle=True)
    assert (s.nranks, s.local_rank) == (1, 0)
    s.set_epoch(3)
    r = jio.DistributedBatchSampler(ds, 4, num_replicas=1, rank=0,
                                    shuffle=True)
    r.set_epoch(3)
    assert list(s) == list(r) and len(s) == len(r)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    s = pio.DistributedBatchSampler(ds, 4, shuffle=True)
    r = jio.DistributedBatchSampler(ds, 4, shuffle=True)
    assert (s.nranks, s.local_rank) == (r.nranks, r.local_rank) == (2, 1)
    assert list(s) == list(r) and len(s) == len(r)


def test_datasets_give_the_reference_items():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    y = np.arange(6, dtype=np.int64)
    for io in (jio, pio):
        assert io.Dataset is not None
    pt_t = pio.TensorDataset([pt.to_tensor(x), y])
    j_t = jio.TensorDataset([paddle_tpu.to_tensor(x), y])
    assert len(pt_t) == len(j_t) == 6
    for i in range(6):
        assert_same(pt_t[i], j_t[i])
    comp = [io.ComposeDataset([io.TensorDataset([x]), io.TensorDataset([y])])
            for io in (jio, pio)]
    conc = [io.ConcatDataset([io.TensorDataset([x]), io.Subset(
        io.TensorDataset([y]), [5, 0, 3])]) for io in (jio, pio)]
    for a, b in (comp, conc):
        assert len(a) == len(b)
        for i in range(-len(a), len(a)):
            assert_same(a[i], b[i])
    with pytest.raises(ValueError):
        pio.ComposeDataset([pio.TensorDataset([x]), pio.TensorDataset([y[:3]])])

    class Stream(pio.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(range(self.n))

    chain = pio.ChainDataset([Stream(2), Stream(3)])
    assert [v for v in chain] == [0, 1, 0, 1, 2]
    with pytest.raises(RuntimeError):
        len(chain)


# -- the DataLoader --------------------------------------------------------


def _images(n=20, shape=(3, 128, 128)):
    rng = np.random.RandomState(4)
    return (rng.rand(n, *shape).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int64))


def _epoch(loader, seed):
    np.random.seed(seed)
    return [host(b) for b in loader]


def _reference_batches(seed, **kw):
    x, y = _images()
    return _epoch(jio.DataLoader(jio.TensorDataset([x, y]), **kw), seed)


@pytest.mark.parametrize("workers", [0, 3])
def test_loader_sync_and_thread_paths_equal_the_reference(workers):
    kw = dict(batch_size=6, shuffle=True)
    want = _reference_batches(11, **kw)
    x, y = _images()
    loader = pio.DataLoader(pio.TensorDataset([x, y]), num_workers=workers,
                            use_shared_memory=False, **kw)
    got = _epoch(loader, 11)
    assert len(got) == len(loader) == 4
    assert_same(got, want)
    batch = next(iter(loader))
    assert all(isinstance(t, pt.Tensor) and t.place.kind == "cpu"
               for t in batch)
    assert batch[1].dtype == torch.int64


def test_thread_workers_under_contention_lose_no_count():
    """16 thread workers (more than this host's cores) and a 1 us switch
    interval: the batches equal the sync path's in order, and the native
    library's call counter, which the workers share, loses no update."""
    import sys

    x, y = _images(64, (3, 16, 16))
    kw = dict(batch_size=2, shuffle=True)
    want = _epoch(pio.DataLoader(pio.TensorDataset([x, y]), **kw), 13)
    loader = pio.DataLoader(pio.TensorDataset([x, y]), num_workers=16,
                            use_shared_memory=False, prefetch_factor=4, **kw)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pnative.reset_calls()
        got = _epoch(loader, 13)
        calls = pnative.calls()["stack_samples"]
    finally:
        sys.setswitchinterval(saved)
    assert_same(got, want)
    assert calls["native"] + calls["numpy"] == 32


def _shm_names():
    return {n for n in os.listdir("/dev/shm") if n.startswith("psm_")}


def test_loader_process_workers_equal_the_reference():
    """Spawned workers through /dev/shm, persistent across epochs: the
    first and third epochs equal the JAX package's sync batches under
    the same seeds, the second stops after one batch and leaves no
    segment behind; the workers' native staging calls reach the
    parent's counts."""
    kw = dict(batch_size=6, shuffle=True, drop_last=False)
    want = _reference_batches(12, **kw)
    x, y = _images()
    loader = pio.DataLoader(pio.TensorDataset([x, y]), num_workers=2,
                            use_shared_memory=True, persistent_workers=True,
                            **kw)
    before = _shm_names()
    pnative.reset_calls()
    try:
        assert_same(_epoch(loader, 12), want)
        assert loader._pool_is_proc
        worker_calls = pnative.calls()
        for batch in loader:
            break
        assert_same(_epoch(loader, 12), want)
    finally:
        loader._pool.shutdown()
    assert _shm_names() <= before
    pnative.reset_calls()
    sync = pio.DataLoader(pio.TensorDataset([x, y]), **kw)
    _epoch(sync, 12)
    assert worker_calls == pnative.calls()
    assert worker_calls["stack_samples"]["native"] == 3


def test_loader_over_an_iterable_dataset():
    out = []
    for io in (jio, pio):
        class Stream(io.IterableDataset):
            def __iter__(self):
                return (np.full(3, i, np.float32) for i in range(10))

        out.append([host(b) for b in io.DataLoader(Stream(), batch_size=4)]
                   + [host(b) for b in io.DataLoader(
                       Stream(), batch_size=4, drop_last=True)])
    assert_same(out[0], out[1])
    assert len(out[1]) == 5


def test_shm_codec_round_trip_unlinks_its_segments():
    big = np.random.RandomState(0).rand(64, 512).astype(np.float32)
    tree = {"a": (big, np.arange(3)), "b": [7, big.astype(np.float64)],
            "c": "text"}
    enc = pdl._shm_encode(tree)
    names = [enc["a"][0][1], enc["b"][1][1]]
    assert enc["a"][0][0] == "__shm__" and isinstance(enc["a"][1],
                                                      np.ndarray)
    assert all(os.path.exists(f"/dev/shm/{n}") for n in names)
    assert_same(pdl._shm_decode(enc), tree)
    assert not any(os.path.exists(f"/dev/shm/{n}") for n in names)
    # the reference decodes the port's encoding (the same wire form)
    assert_same(jio.dataloader._shm_decode(pdl._shm_encode(tree)), tree)


COLLATE = {
    "native_arrays": lambda: [np.full((256, 1024), i, np.float32)
                              for i in range(8)],
    "small_arrays": lambda: [np.full((2, 3), i, np.int32) for i in range(4)],
    "scalars": lambda: [(1, 2.5), (3, 4.5)],
    "dicts": lambda: [{"x": np.ones(2) * i, "y": i} for i in range(3)],
    "tensors": None,
}


@pytest.mark.parametrize("kind", sorted(COLLATE))
def test_default_collate_fn_equals_the_reference(kind):
    if kind == "tensors":
        vals = [np.full((2, 2), i, np.float32) for i in range(3)]
        got = pdl.default_collate_fn([pt.to_tensor(v) for v in vals])
        want = jio.default_collate_fn([paddle_tpu.to_tensor(v)
                                       for v in vals])
        assert isinstance(got, pt.Tensor)
        assert_same(host(got), host(want))
        return
    pnative.reset_calls()
    got = pdl.default_collate_fn(COLLATE[kind]())
    assert_same(got, jio.default_collate_fn(COLLATE[kind]()))
    if kind == "native_arrays":
        assert pnative.calls()["stack_samples"] == {"native": 1, "numpy": 0}


def test_vision_collate_fn_is_bit_equal_to_the_reference():
    rng = np.random.RandomState(1)
    batch = [(rng.randint(0, 256, (3, 64, 64)).astype(np.uint8), i)
             for i in range(8)]
    pnative.reset_calls()
    got = pio.vision_collate_fn(batch)
    want = jio.vision_collate_fn(batch)
    assert got[0].dtype == np.float32
    assert got[0].view(np.uint32).tobytes() == \
        want[0].view(np.uint32).tobytes()
    assert_same(got[1], want[1])
    assert pnative.calls()["stack_u8_to_f32"] == {"native": 1, "numpy": 0}
    floats = [(np.ones((2, 2), np.float32), 0)] * 2
    assert_same(pio.vision_collate_fn(floats),
                jio.vision_collate_fn(floats))


def test_loader_legacy_constructors():
    x, y = _images(4, (2,))
    for io in (jio, pio):
        with pytest.raises(NotImplementedError):
            io.DataLoader.from_generator()
        dl = io.DataLoader.from_dataset(io.TensorDataset([x, y]))
        assert len(dl) == 4


# -- the native staging library --------------------------------------------


def test_native_library_is_bit_equal_to_the_reference_and_numpy():
    assert pnative.available() and jnative.available()
    rng = np.random.RandomState(3)
    u8 = [rng.randint(0, 256, (3, 224, 224)).astype(np.uint8)
          for _ in range(16)]
    got = pnative.stack_u8_to_f32(u8)
    plain = np.stack(u8).astype(np.float32) * (1.0 / 255.0)
    for want in (jnative.stack_u8_to_f32(u8), plain):
        assert got.view(np.uint32).tobytes() == \
            want.view(np.uint32).tobytes()
    got = pnative.stack_u8_to_f32(u8, scale=0.5 / 255.0, shift=-0.25)
    want = jnative.stack_u8_to_f32(u8, scale=0.5 / 255.0, shift=-0.25)
    assert got.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()
    f32 = [rng.rand(1024, 1024).astype(np.float32) for _ in range(9)]
    assert np.stack(f32).tobytes() == pnative.stack_samples(f32).tobytes()
    assert jnative.stack_samples(f32).tobytes() == \
        pnative.stack_samples(f32).tobytes()


def test_native_library_builds_into_the_package():
    lib = pnative.lib()
    assert lib is not None and pnative.build_error() is None
    path = pnative._lib_path()
    assert path.parent == pnative.BUILD_DIR
    assert path.parent.parent.name == "paddle_tpu_torch"
    assert path.name.startswith("libptstaging-") and path.exists()
    assert lib._name == str(path)


def test_native_reports_a_missing_toolchain(monkeypatch, tmp_path):
    """No g++: ``available()`` is False, ``build_error()`` says why, and
    both functions run their numpy versions, counted as such."""
    monkeypatch.setattr(pnative, "_LIB", None)
    monkeypatch.setattr(pnative, "_TRIED", False)
    monkeypatch.setattr(pnative, "_ERROR", None)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not pnative.available()
    assert "g++" in pnative.build_error() or "No such file" in \
        pnative.build_error()
    pnative.reset_calls()
    u8 = [np.full((4, 4), 9, np.uint8)] * 3
    assert np.array_equal(pnative.stack_u8_to_f32(u8),
                          np.full((3, 4, 4), 9 / 255, np.float32))
    assert pnative.calls()["stack_u8_to_f32"] == {"native": 0, "numpy": 1}


# -- reader and batch --------------------------------------------------------


def _r(n=7):
    return lambda: iter(range(n))


READERS = {
    "cache": lambda R: R.cache(_r()),
    "map_readers": lambda R: R.map_readers(lambda a, b: a * 10 + b, _r(),
                                           _r(5)),
    "shuffle": lambda R: R.shuffle(_r(11), 4),
    "chain": lambda R: R.chain(_r(2), _r(3)),
    "compose": lambda R: R.compose(_r(3), lambda: iter([(1, 2)] * 3)),
    "buffered": lambda R: R.buffered(_r(), 2),
    "firstn": lambda R: R.firstn(_r(), 3),
    "xmap_readers": lambda R: R.xmap_readers(lambda v: v * v, _r(), 2, 3),
    "batch": lambda R: (pt.batch if R is preader else paddle_tpu.batch)(
        _r(), 3),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_decorators_equal_the_reference(name):
    out = []
    for R in (jreader, preader):
        random.seed(4)
        r = READERS[name](R)
        out.append((list(r()), list(r())))
    assert out[0] == out[1]
    if name == "compose":
        bad = preader.compose(_r(3), _r(2))
        with pytest.raises(preader.ComposeNotAligned):
            list(bad())
    if name == "batch":
        assert list(pt.batch(_r(), 3, drop_last=True)()) == \
            list(paddle_tpu.batch(_r(), 3, drop_last=True)())
        with pytest.raises(ValueError):
            pt.batch(_r(), 0)


def test_dataset_staging_paths(monkeypatch, tmp_path):
    from paddle_tpu.utils import download as jdl
    from paddle_tpu_torch.utils import download as pdlw

    monkeypatch.delenv("PADDLE_DATASET_HOME", raising=False)
    assert pdlw.dataset_home() == jdl.dataset_home()
    monkeypatch.setenv("PADDLE_DATASET_HOME", str(tmp_path))
    assert pdlw.dataset_home() == str(tmp_path)
    url = "https://example.invalid/data/file.tgz"
    with pytest.raises(RuntimeError, match="download"):
        pdlw.get_path_from_url(url)
    (tmp_path / "file.tgz").write_bytes(b"x")
    assert pdlw.get_path_from_url(url) == jdl.get_path_from_url(url) == \
        str(tmp_path / "file.tgz")
