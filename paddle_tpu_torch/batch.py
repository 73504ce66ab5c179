"""paddle.batch (counterpart of ``paddle_tpu/batch.py``; reference:
python/paddle/batch.py:18): wrap a sample reader (a zero-arg generator
factory) into a mini-batch reader."""
from __future__ import annotations

__all__ = ["batch"]


def batch(reader, batch_size, drop_last=False):
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")

    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader
