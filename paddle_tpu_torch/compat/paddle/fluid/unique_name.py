"""paddle.fluid.unique_name — deterministic name generator (counterpart
of the JAX package's ``paddle/fluid/unique_name.py``).

Reference: python/paddle/fluid/unique_name.py (UniqueNameGenerator :27,
guard :119). Scripts use it to name parameters reproducibly across two
program builds; the counter map + guard semantics are preserved.
"""
from __future__ import annotations

import contextlib

__all__ = ["generate", "switch", "guard"]

_counters: dict = {}


def generate(key: str) -> str:
    n = _counters.get(key, 0)
    _counters[key] = n + 1
    return f"{key}_{n}"


def switch(new_generator=None):
    global _counters
    old = _counters
    _counters = new_generator if isinstance(new_generator, dict) else {}
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
