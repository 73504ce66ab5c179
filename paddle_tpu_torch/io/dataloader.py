"""DataLoader (counterpart of ``paddle_tpu/io/dataloader.py``; reference:
python/paddle/fluid/reader.py:149 DataLoader, fluid/dataloader/
dataloader_iter.py:265 single-process iter, :469 multi-process iter with
shared-memory workers).

Workers fetch and collate ahead of the consumer. With ``num_workers`` > 0
a spawned process pool is used when ``use_shared_memory=True`` and the
dataset and collate function pickle (the dataset travels once, through
the workers' initializer; each worker hides the card and pins the port to
the CPU first), a thread pool otherwise. Process workers return each
batch's arrays in ``/dev/shm`` segments and send only their names through
the result pipe (``_shm_encode`` / ``_shm_decode``, which reads a segment
with ``preadv`` instead of mapping it), with the counts of their native
staging calls (``native.calls()`` of the parent adds them).
Workers make numpy only.

The consumer turns each batch into ``Tensor`` on the current device
(``set_device``; ``places`` is taken and not used, as in the JAX
package): on the card, each array goes
into a pinned host buffer (a process worker's segment is decoded straight
into it) and from there to the device with one ``non_blocking`` copy on
the current stream. A pinned buffer is taken again only when the event
recorded after its copy has completed; otherwise a new one is allocated.
On the CPU, batches are CPU tensors.

Departure: the JAX package bounds its queue of pending fetches, so up to
about twice ``num_workers * prefetch_factor`` finished batches can wait in
``/dev/shm``; here at most ``num_workers * prefetch_factor`` batches are
in flight (submitted and not yet decoded by the consumer), so that bound
is what ``/dev/shm`` must hold.

With process workers, a pinning thread of the consumer's process decodes
their segments into pinned buffers ahead of the consumer (up to
``_PIN_AHEAD`` batches), so that the host copy of a batch overlaps the
step that consumes the previous one.

``timing``: set it to a :class:`LoaderTiming` to record per batch where
the consumer's time goes.
"""
from __future__ import annotations

import itertools
import os
import pickle
import queue
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import infer_dtype_from_data
from ..core.tensor import Tensor
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "LoaderTiming", "default_collate_fn",
           "vision_collate_fn"]

_PROC_STATE = {}


def _proc_worker_init(dataset, collate_fn):
    """Runs once per spawned worker: hide the card and pin the port to the
    CPU (a worker never touches CUDA), then bind the dataset and collate
    function (spawn ships them exactly once)."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from ..core import device

    device._current = torch.device("cpu")
    _PROC_STATE["dataset"] = dataset
    _PROC_STATE["collate"] = collate_fn


def _proc_worker_fetch(indices):
    ds = _PROC_STATE["dataset"]
    return _PROC_STATE["collate"]([ds[i] for i in indices])


# Shared-memory return transport (reference: the use_shared_memory path of
# fluid/dataloader/dataloader_iter.py): workers place batch arrays in
# /dev/shm segments and send only metadata through the result pipe.
_SHM_MIN_BYTES = 1 << 16  # small arrays pickle cheaper than a shm segment
_PIN_AHEAD = 2  # batches the pinning thread decodes ahead of the consumer


def _shm_encode(obj):
    if isinstance(obj, np.ndarray) and obj.nbytes >= _SHM_MIN_BYTES:
        from multiprocessing import resource_tracker, shared_memory

        arr = np.ascontiguousarray(obj)
        shm = shared_memory.SharedMemory(create=True, size=arr.nbytes)
        np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)[...] = arr
        name = shm.name
        shm.close()
        # the PARENT owns the segment's lifetime (it unlinks after the
        # decode); stop this process's resource tracker from unlinking it
        # again at worker exit
        try:
            resource_tracker.unregister("/" + name, "shared_memory")
        except Exception:
            pass
        return ("__shm__", name, arr.shape, str(arr.dtype))
    if isinstance(obj, tuple):
        return tuple(_shm_encode(o) for o in obj)
    if isinstance(obj, list):
        return [_shm_encode(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _shm_encode(v) for k, v in obj.items()}
    return obj


def _read_segment(name: str, out: np.ndarray) -> None:
    """Copy segment ``name`` into the contiguous ``out`` with ``preadv``
    calls (the kernel copies from the page cache; nothing is mapped into
    this process, so no page faults and no unmap while holding the GIL),
    then unlink it."""
    path = os.path.join("/dev/shm", name)
    fd = os.open(path, os.O_RDONLY)
    try:
        view = memoryview(out.reshape(-1).view(np.uint8))
        done = 0
        while done < len(view):
            n = os.preadv(fd, [view[done:]], done)
            if n == 0:
                raise EOFError(f"{path}: {done} of {len(view)} bytes")
            done += n
    finally:
        os.close(fd)
        os.unlink(path)


def _shm_decode(obj, alloc=None):
    """Read the segments of an encoded batch and unlink them. Each array
    is read into ``alloc(shape, dtype)`` (a pinned buffer of the stager)
    when given, else into a new numpy array."""
    if isinstance(obj, tuple) and len(obj) == 4 and obj[0] == "__shm__":
        _, name, shape, dtype = obj
        shape, dtype = tuple(shape), np.dtype(dtype)
        out = np.empty(shape, dtype) if alloc is None else alloc(shape, dtype)
        _read_segment(name, out)
        return out
    if isinstance(obj, tuple):
        return tuple(_shm_decode(o, alloc) for o in obj)
    if isinstance(obj, list):
        return [_shm_decode(o, alloc) for o in obj]
    if isinstance(obj, dict):
        return {k: _shm_decode(v, alloc) for k, v in obj.items()}
    return obj


def _proc_worker_fetch_shm(indices):
    from .. import native

    return _shm_encode(_proc_worker_fetch(indices)), native._take_calls()


def default_collate_fn(batch):
    """Stack samples into batch arrays (reference:
    fluid/dataloader/collate.py default_collate_fn)."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return Tensor._wrap(torch.stack([s._data for s in batch]))
    if isinstance(sample, np.ndarray):
        if (len(batch) > 1 and sample.ndim > 0
                and not sample.dtype.hasobject
                and all(s.shape == sample.shape
                        and s.dtype == sample.dtype
                        and s.flags.c_contiguous for s in batch)):
            # native GIL-free collation (staging.cpp pt_stack; numpy
            # inside when the library is not available)
            from .. import native

            return native.stack_samples(batch)
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn(list(col)) for col in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    return np.asarray(batch)


def vision_collate_fn(batch):
    """Collate for (uint8 image, label) vision samples with the native
    fused stack + uint8 -> float32 /255 (staging.cpp pt_stack_u8_to_f32):
    use as DataLoader(collate_fn=vision_collate_fn) with datasets that
    keep images uint8 and skip transforms.ToTensor's per-sample division.
    Other batches go to the default collate."""
    sample = batch[0]
    if (isinstance(sample, (tuple, list)) and len(sample) == 2
            and isinstance(sample[0], np.ndarray)
            and sample[0].dtype == np.uint8
            and all(s[0].shape == sample[0].shape
                    and s[0].flags.c_contiguous for s in batch)):
        from .. import native

        imgs = native.stack_u8_to_f32([s[0] for s in batch])
        labels = default_collate_fn([s[1] for s in batch])
        return imgs, labels
    return default_collate_fn(batch)


class LoaderTiming:
    """Per-batch readings of a loader with workers: ``wait_s`` (seconds
    the consumer waited for the next pinned batch), ``stage_s`` (its host
    seconds launching the batch's copies to the device), the device time
    of those copies (``h2d_ms()``, which synchronizes), and in the
    pinning thread ``worker_wait_s`` (seconds it waited for a worker's
    result) and ``decode_s`` (seconds decoding it into pinned buffers).
    The sync path records the copies alone."""

    def __init__(self):
        self.wait_s: List[float] = []
        self.stage_s: List[float] = []
        self.worker_wait_s: List[float] = []
        self.decode_s: List[float] = []
        self._h2d: List = []

    def h2d_ms(self) -> List[float]:
        if self._h2d:
            torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self._h2d]


class _Stager:
    """Numpy batches -> ``Tensor`` on ``device`` (see the module notes).

    ``_free`` holds pinned buffers with the event recorded after the copy
    that last read them; ``_pending`` the buffers handed out by
    :meth:`host_array` whose copy is not issued yet, by data address. The
    loader's pinning thread takes buffers while the consumer gives them
    back: both go through ``_lock``."""

    _MAX_FREE = 8

    def __init__(self, device: torch.device):
        self.device = device
        self._free: list = []
        self._pending: dict = {}
        self._lock = threading.Lock()

    def _take(self, nbytes: int) -> torch.Tensor:
        """The smallest free buffer that holds ``nbytes`` and whose copy
        has completed, unless it is more than twice as large (a label
        array must not take an image batch's buffer); else a new one."""
        with self._lock:
            best = None
            for i, (buf, ev) in enumerate(self._free):
                size = buf.numel()
                if nbytes <= size <= 2 * nbytes + 4096 and (
                        best is None or size < self._free[best][0].numel()
                ) and (ev is None or ev.query()):
                    best = i
            if best is not None:
                return self._free.pop(best)[0]
        return torch.empty(max(nbytes, 1), dtype=torch.uint8,
                           pin_memory=True)

    def _give(self, buf: torch.Tensor, ev) -> None:
        with self._lock:
            self._free.append((buf, ev))
            if len(self._free) > self._MAX_FREE:
                # drop the oldest: the caching host allocator keeps its
                # memory until the copies recorded on it complete
                self._free.pop(0)

    def host_array(self, shape, dtype) -> np.ndarray:
        """A writable array in a pinned buffer (for ``_shm_decode``)."""
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        buf = self._take(nbytes)
        arr = buf.numpy()[:nbytes].view(dtype).reshape(shape)
        with self._lock:
            self._pending[arr.ctypes.data] = buf
        return arr

    def drop_pending(self) -> None:
        """Return the buffers of batches that were never staged."""
        with self._lock:
            bufs, self._pending = list(self._pending.values()), {}
        for buf in bufs:
            self._give(buf, None)

    def tree(self, obj, timing: Optional[LoaderTiming] = None):
        on_card = self.device.type == "cuda"
        if on_card and timing is not None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._tree(obj)
            end.record()
            timing._h2d.append((start, end))
            return out
        return self._tree(obj)

    def _tree(self, obj):
        if isinstance(obj, np.ndarray):
            return Tensor._wrap(self._stage(obj))
        if isinstance(obj, Tensor):
            return obj
        if isinstance(obj, tuple):
            return tuple(self._tree(o) for o in obj)
        if isinstance(obj, list):
            return [self._tree(o) for o in obj]
        if isinstance(obj, dict):
            return {k: self._tree(v) for k, v in obj.items()}
        return Tensor(np.asarray(obj), place=self.device)

    def _stage(self, arr: np.ndarray) -> torch.Tensor:
        dtype = infer_dtype_from_data(arr)
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
        with self._lock:
            buf = self._pending.pop(arr.ctypes.data, None)
        src = None if buf is None else torch.from_numpy(arr)
        if src is None or src.dtype != dtype:
            host = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
            if buf is not None:
                self._give(buf, None)  # no copy was issued from it
            nbytes = host.numel() * host.element_size()
            buf = self._take(nbytes)
            src = buf[:nbytes].view(dtype).view(host.shape)
            src.copy_(host)
        out = src.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self._give(buf, ev)
        return out


class DataLoader:
    def __init__(
        self,
        dataset: Dataset,
        feed_list=None,
        places=None,
        return_list=True,
        batch_sampler: Optional[BatchSampler] = None,
        batch_size=1,
        shuffle=False,
        drop_last=False,
        collate_fn: Optional[Callable] = None,
        num_workers=0,
        use_buffer_reader=True,
        use_shared_memory=True,
        prefetch_factor=2,
        timeout=0,
        worker_init_fn=None,
        persistent_workers=False,
    ):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = int(num_workers)
        self.prefetch_factor = max(int(prefetch_factor), 1)
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        self.persistent_workers = persistent_workers
        self.timing: Optional[LoaderTiming] = None
        self._pool = None
        self._pool_is_proc = False
        self._stager: Optional[_Stager] = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last,
            )

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()

    def __iter__(self):
        dev = resolve_device(None)
        if self._stager is None or self._stager.device != dev:
            self._stager = _Stager(dev)
        if self._iterable_mode:
            yield from self._iter_iterable()
        elif self.num_workers == 0 or not self.use_buffer_reader:
            yield from self._iter_sync()
        else:
            yield from self._iter_prefetch()

    # -- paths ---------------------------------------------------------------
    def _fetch(self, indices):
        batch = [self.dataset[i] for i in indices]
        return self.collate_fn(batch)

    def _iter_sync(self):
        for indices in self.batch_sampler:
            yield self._stager.tree(self._fetch(indices), self.timing)

    def _iter_iterable(self):
        it = iter(self.dataset)
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch:
                return
            if len(batch) < self.batch_size and self.drop_last:
                return
            yield self._stager.tree(self.collate_fn(batch), self.timing)

    def _make_pool(self):
        """Process workers when shared memory is requested and the dataset
        and collate function pickle (spawned, so the dataset travels once
        through the initializer); a thread pool otherwise. The pool
        persists across epochs when persistent_workers=True."""
        if self._pool is not None:
            return self._pool
        pool = None
        if self.use_shared_memory:
            try:
                # probe picklability without materializing the bytes
                class _Null:
                    def write(self, b):
                        return len(b)

                pickle.Pickler(_Null(), protocol=4).dump(self.dataset)
                pickle.Pickler(_Null(), protocol=4).dump(self.collate_fn)
            except Exception:
                pool = ThreadPoolExecutor(max_workers=self.num_workers)
                self._pool_is_proc = False
            else:
                import multiprocessing as mp

                from .. import native

                native.lib()  # build once here, not in every worker
                pool = ProcessPoolExecutor(
                    max_workers=self.num_workers,
                    mp_context=mp.get_context("spawn"),
                    initializer=_proc_worker_init,
                    initargs=(self.dataset, self.collate_fn),
                )
                self._pool_is_proc = True
        else:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            self._pool_is_proc = False
        if self.persistent_workers:
            self._pool = pool
        return pool

    def _iter_prefetch(self):
        """Worker-pool fetch ahead of the consumer, at most
        ``num_workers * prefetch_factor`` batches in flight. A pinning
        thread takes the workers' results in order and decodes a process
        worker's ``/dev/shm`` segments into pinned buffers, up to
        ``_PIN_AHEAD`` batches ahead, so that the host copy overlaps the
        consumer's step; the consumer launches the copies to the device
        (and first copies a thread worker's arrays into pinned buffers)."""
        from .. import native

        depth = self.num_workers * self.prefetch_factor
        pool = self._make_pool()
        is_proc = self._pool_is_proc
        futures: "queue.Queue" = queue.Queue()
        ready: "queue.Queue" = queue.Queue(maxsize=_PIN_AHEAD)
        slots = threading.Semaphore(depth)
        sentinel = object()
        stop = threading.Event()
        stager = self._stager
        on_card = stager.device.type == "cuda"
        timing = self.timing

        def submit(indices):
            if is_proc:
                return pool.submit(_proc_worker_fetch_shm, list(indices))
            return pool.submit(self._fetch, indices)

        def reap(fut):
            """Cancel a pending fetch; if it already completed, decode its
            shm descriptors so the segments are unlinked, not leaked."""
            if not fut.cancel() and is_proc:
                try:
                    _shm_decode(fut.result(timeout=5)[0])
                except Exception:
                    pass

        def put(q, item):
            """Blocking put that gives up when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for indices in self.batch_sampler:
                    while not slots.acquire(timeout=0.05):
                        if stop.is_set():
                            return
                    if stop.is_set():
                        slots.release()
                        return
                    futures.put(submit(indices))
            finally:
                futures.put(sentinel)

        def pinner():
            try:
                while not stop.is_set():
                    fut = futures.get()
                    if fut is sentinel:
                        break
                    t0 = time.perf_counter()
                    out = fut.result()
                    t1 = time.perf_counter()
                    if is_proc:
                        out, counts = out
                        native._add_calls(counts)
                        out = _shm_decode(
                            out, stager.host_array if on_card else None)
                    slots.release()
                    if timing is not None:
                        timing.worker_wait_s.append(t1 - t0)
                        timing.decode_s.append(time.perf_counter() - t1)
                    if not put(ready, out):
                        return
            except Exception as e:  # re-raised by the consumer
                put(ready, e)
            finally:
                put(ready, sentinel)

        threads = [threading.Thread(target=f, daemon=True)
                   for f in (producer, pinner)]
        for t in threads:
            t.start()
        try:
            while True:
                t0 = time.perf_counter()
                out = ready.get()
                if out is sentinel:
                    break
                if isinstance(out, BaseException):
                    raise out
                t1 = time.perf_counter()
                out = stager.tree(out, timing)
                if timing is not None:
                    timing.wait_s.append(t1 - t0)
                    timing.stage_s.append(time.perf_counter() - t1)
                yield out
        finally:
            # early break or an error: stop both threads, reap what was
            # submitted, so a persistent pool is clean for the next epoch
            stop.set()
            while threads[1].is_alive():
                try:
                    ready.get(timeout=0.05)
                except queue.Empty:
                    pass
            threads[0].join()
            while True:
                try:
                    item = futures.get_nowait()
                except queue.Empty:
                    break
                if item is not sentinel:
                    reap(item)
            stager.drop_pending()
            if pool is not self._pool:
                pool.shutdown(wait=False, cancel_futures=True)

    # -- legacy constructors (fluid reader API) ------------------------------
    @staticmethod
    def from_generator(feed_list=None, capacity=None, use_double_buffer=True,
                       iterable=True, return_list=False, use_multiprocess=False,
                       drop_last=True):
        raise NotImplementedError(
            "Legacy fluid DataLoader.from_generator: build a paddle_tpu_torch"
            ".io.Dataset and use DataLoader(dataset=...) instead"
        )

    @staticmethod
    def from_dataset(dataset, places=None, drop_last=True):
        return DataLoader(dataset, drop_last=drop_last)
