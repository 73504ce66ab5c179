"""paddle.fluid.executor — Executor/scope under the 1.x module path
(counterpart of the JAX package's ``paddle/fluid/executor.py``).

Reference: python/paddle/fluid/executor.py. `Executor.run` replays the
recorded Program on its place (``paddle_tpu_torch.static.executor``);
`scope_guard` is accepted for script parity — variable storage is the
live tensor objects, there is no C++ scope tree to swap.
"""
from __future__ import annotations

import contextlib

from paddle_tpu_torch.static import CompiledProgram, Executor, global_scope  # noqa: F401

__all__ = ["Executor", "global_scope", "scope_guard", "Scope",
           "CompiledProgram"]


class Scope:
    """executor.py Scope stand-in: find_var resolves through the single
    global scope (parameters/fetches are live objects here)."""

    def find_var(self, name):
        return global_scope().find_var(name)


@contextlib.contextmanager
def scope_guard(scope):
    yield scope
