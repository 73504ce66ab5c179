"""paddle.fluid.data_feeder — DataFeeder for reader-protocol loops
(counterpart of the JAX package's ``paddle/fluid/data_feeder.py``).

Reference: python/paddle/fluid/data_feeder.py:271 (`DataFeeder.feed`
converts a minibatch of reader samples into the feed dict, casting each
column to its placeholder's dtype and reshaping to the placeholder's
static shape with -1 batch).
"""
from __future__ import annotations

import numpy as np

__all__ = ["DataFeeder", "convert_dtype"]


def convert_dtype(dtype):
    from paddle_tpu_torch.core.dtype import dtype_name

    return dtype_name(dtype)


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_list = list(feed_list)
        self.place = place
        self._vars = []
        from paddle_tpu_torch.static.program import static_var

        for f in self.feed_list:
            v = static_var(f)
            if v is None:
                raise TypeError(
                    "DataFeeder feed_list entries must be fluid.data/"
                    f"fluid.layers.data placeholders, got {type(f)}"
                )
            self._vars.append(v)

    def feed(self, iterable):
        """list of per-sample tuples -> {name: batched ndarray}."""
        rows = list(iterable)
        out = {}
        for i, v in enumerate(self._vars):
            col = [np.asarray(r[i]) for r in rows]
            arr = np.stack(col, axis=0).astype(convert_dtype(v.dtype))
            tail = tuple(d for d in v.shape[1:])
            if all(d is not None and d >= 0 for d in tail):
                arr = arr.reshape((arr.shape[0],) + tail)
            out[v.name] = arr
        return out
