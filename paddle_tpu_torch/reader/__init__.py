"""``reader`` of the port: sample-reader decorators (counterpart of
``paddle_tpu/reader/__init__.py``).

Reference: python/paddle/reader/decorator.py (cache :51, map_readers :91,
shuffle :133, chain :182, compose :247, buffered :307, firstn :366,
xmap_readers :411). A "reader" is a zero-arg callable returning an
iterator of samples; decorators compose them. These feed ``paddle.batch``
and fluid-era training scripts; the modern path is ``io.DataLoader``.
``shuffle`` draws from Python's ``random`` stream, as the JAX package's
does; ``xmap_readers`` maps with threads and keeps submission order.
"""
from __future__ import annotations

import itertools
import queue as _queue
import random as _random
import threading

__all__ = [
    "cache", "map_readers", "buffered", "compose", "chain", "shuffle",
    "firstn", "xmap_readers",
]


def cache(reader):
    """Materialize once, replay from memory thereafter (decorator.py:51)."""
    all_data = None

    def cached():
        nonlocal all_data
        if all_data is None:
            all_data = tuple(reader())
        return iter(all_data)

    return cached


def map_readers(func, *readers):
    """Zip several readers, yield func(*samples) (decorator.py:91)."""

    def mapped():
        its = [r() for r in readers]
        for sample in zip(*its):
            yield func(*sample)

    return mapped


def shuffle(reader, buf_size):
    """Buffered shuffle (decorator.py:133): fill a buf_size window,
    shuffle it, emit; tail window included."""

    def shuffled():
        buf = []
        for s in reader():
            buf.append(s)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return shuffled


def chain(*readers):
    """Concatenate readers (decorator.py:182)."""

    def chained():
        return itertools.chain(*[r() for r in readers])

    return chained


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """Zip readers into flattened tuples (decorator.py:247):
    (a, (b, c)) -> (a, b, c). check_alignment=True (default) raises
    ComposeNotAligned when one reader ends early."""
    check_alignment = kwargs.pop("check_alignment", True)
    if kwargs:
        raise TypeError(
            f"compose() got unexpected keyword arguments {sorted(kwargs)}"
        )

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def composed():
        its = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*its):
                yield sum((make_tuple(o) for o in outputs), ())
            return
        sentinel = object()
        for outputs in itertools.zip_longest(*its, fillvalue=sentinel):
            if any(o is sentinel for o in outputs):
                raise ComposeNotAligned(
                    "outputs of readers are not aligned (different lengths)"
                )
            yield sum((make_tuple(o) for o in outputs), ())

    return composed


def buffered(reader, size):
    """Background-thread prefetch queue of `size` samples
    (decorator.py:307). Reader exceptions re-raise in the CONSUMER (a
    truncated stream must not look like a clean end), and abandoning
    the generator early releases the fill thread instead of leaving it
    blocked on a full queue forever."""

    def buffered_():
        q: "_queue.Queue" = _queue.Queue(maxsize=size)
        end = object()
        stop = threading.Event()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except _queue.Full:
                    continue
            return False

        def fill():
            try:
                for s in reader():
                    if not put(s):
                        return
            except BaseException as e:  # propagate to the consumer
                put(e)
                return
            put(end)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        try:
            while True:
                s = q.get()
                if s is end:
                    return
                if isinstance(s, BaseException):
                    raise s
                yield s
        finally:
            stop.set()  # unblock + retire the fill thread on early exit

    return buffered_


def firstn(reader, n):
    """First n samples (decorator.py:366)."""

    def firstn_():
        return itertools.islice(reader(), n)

    return firstn_


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over samples (decorator.py:411). Thread workers (the
    reference forks processes around the GIL for CPU-bound python
    mappers; on this stack numpy mappers release the GIL and true
    process parallelism belongs to io.DataLoader's spawned workers).
    `order` is accepted for API parity; submission order is always
    preserved here. Early generator exit cancels the in-flight window
    instead of draining it."""
    del order
    from concurrent.futures import ThreadPoolExecutor

    def xmapped():
        pool = ThreadPoolExecutor(max_workers=process_num)
        try:
            futures = []
            for s in reader():
                futures.append(pool.submit(mapper, s))
                if len(futures) >= buffer_size:
                    yield futures.pop(0).result()
            for f in futures:
                yield f.result()
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    return xmapped
