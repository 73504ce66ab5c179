"""The recompile ledger: every new program capture becomes a bus row
(counterpart of ``paddle_tpu/observability/ledger.py``).

In the JAX package a miss is a ``jax.jit`` cache miss. In the port the
programs that get captured are ``jit.to_static``'s: a ``StaticFunction``
keeps one ``torch.export`` capture per input signature and training
flags (``jit/program.py``), and a call whose signature is new captures
again. :func:`instrument` wraps such a function (or anything with a
``program_cache`` or ``_cache_size``):

- a miss is read off the cache's size across a call (one integer compare
  on the hit path);
- each miss emits a ``recompile`` row with the call's argument
  fingerprint (per-leaf ``dtype[shape]`` strings, the JAX package's
  spelling), the wall seconds of the capturing call and the label's
  ordinal;
- from the ``PADDLE_OBS_STORM_N``-th capture of one label (default 3) on,
  a ``recompile_storm`` row names the fingerprint fields that keep
  changing.

``jit.TrainStep`` runs eagerly and captures nothing: its label never
records a miss. :func:`install_backend_listener` puts each kernel build
of ``ops/kernels/_build.py`` (one ``nvcc`` per ``csrc/*.cu``) on the bus
as a ``backend_compile`` row with its seconds. :func:`compile_count` is
the process-wide miss total.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

from . import bus

__all__ = [
    "arg_fingerprint", "diff_fingerprints", "instrument",
    "LedgeredFunction", "compile_count", "install_backend_listener",
    "reset",
]

_STORM_ENV = "PADDLE_OBS_STORM_N"

_total_compiles = 0
_listener_installed = False


def compile_count() -> int:
    """Process-wide captures observed by instrumented wrappers."""
    return _total_compiles


def reset() -> None:
    """Tests: zero the process-wide counter."""
    global _total_compiles
    _total_compiles = 0


def _leaf_sig(x) -> str:
    raw = getattr(x, "_data", x)   # a Tensor of the Paddle surface
    shape = getattr(raw, "shape", None)
    dtype = getattr(raw, "dtype", None)
    if shape is None or dtype is None:
        # a constant: its value is part of the cache key
        return f"static:{type(x).__name__}:{x!r}"
    name = str(dtype)
    if name.startswith("torch."):
        name = name[len("torch."):]
    return f"{name}[{','.join(str(int(d)) for d in shape)}]"


def _leaves(x, path=""):
    """``(path, leaf)`` pairs in the JAX package's key spelling: ``[i]``
    for a sequence index, ``['k']`` for a dict key; None has no leaves."""
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return [kv for i, v in enumerate(x) for kv in _leaves(
            v, f"{path}[{i}]")]
    if isinstance(x, dict):
        return [kv for k in sorted(x) for kv in _leaves(
            x[k], f"{path}[{k!r}]")]
    return [(path, x)]


def arg_fingerprint(args, kwargs=None) -> List[Tuple[str, str]]:
    """Flat ``(path, sig)`` list over the call's leaves: the shape and
    type identity a capture keys on, in a diffable form."""
    out: List[Tuple[str, str]] = []
    for i, a in enumerate(args):
        out.extend((f"args[{i}]{p}", _leaf_sig(v)) for p, v in _leaves(a))
    for k, v in sorted((kwargs or {}).items()):
        out.extend((f"{k}{p}", _leaf_sig(leaf)) for p, leaf in _leaves(v))
    return out


def diff_fingerprints(prev, cur) -> List[str]:
    """Lines naming what changed between two fingerprints."""
    pd, cd = dict(prev), dict(cur)
    lines = []
    for key in sorted(set(pd) | set(cd)):
        a, b = pd.get(key), cd.get(key)
        if a == b:
            continue
        if a is None:
            lines.append(f"{key}: (new) {b}")
        elif b is None:
            lines.append(f"{key}: {a} (gone)")
        else:
            lines.append(f"{key}: {a} -> {b}")
    return lines


class LedgeredFunction:
    """Callable wrapper around one capturing function; transparent on the
    hit path (one integer compare and one ``perf_counter`` pair)."""

    def __init__(self, fn, label: str, donate=()):
        self._fn = fn
        self.label = label
        self._donate = tuple(donate)
        self._storm_n = max(int(os.environ.get(_STORM_ENV, "3") or 3), 2)
        self._prev_fp: Optional[List[Tuple[str, str]]] = None
        # without cache introspection: the signatures seen (an A, B, A, B
        # alternation after two captures is all hits)
        self._seen: set = set()
        self.compiles = 0

    def _cache_size(self) -> Optional[int]:
        cache = getattr(self._fn, "program_cache", None)
        if cache is not None:
            return len(cache)
        fn = getattr(self._fn, "_cache_size", None)
        if fn is None:
            return None
        try:
            return int(fn())
        except Exception:  # noqa: BLE001
            return None

    def __call__(self, *args, **kwargs):
        n0 = self._cache_size()
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        wall = time.perf_counter() - t0
        n1 = self._cache_size()
        if n0 is not None and n1 is not None:
            missed = n1 > n0
            fp = arg_fingerprint(args, kwargs) if missed else None
        else:
            fp = arg_fingerprint(args, kwargs)
            key = tuple(fp)
            missed = key not in self._seen
            self._seen.add(key)
        if missed:
            self._on_compile(fp, wall)
        if fp is not None:
            self._prev_fp = fp
        return out

    def _on_compile(self, fp, wall_s: float) -> None:
        global _total_compiles
        self.compiles += 1
        _total_compiles += 1
        changed = (diff_fingerprints(self._prev_fp, fp)
                   if self._prev_fp is not None and fp is not None else [])
        if not bus.enabled():
            return
        bus.emit("recompile", {
            "label": self.label,
            "ordinal": self.compiles,
            "compile_wall_s": round(wall_s, 3),
            "donate_argnums": list(self._donate),
            "fingerprint": [list(kv) for kv in (fp or [])],
            "changed": changed,
        })
        if self.compiles >= self._storm_n and changed:
            bus.emit("recompile_storm", {
                "label": self.label,
                "compiles": self.compiles,
                "changing_fields": changed[:8],
                "detail": (
                    f"{self.label} compiled {self.compiles}x — the "
                    f"argument signature keeps changing: "
                    + "; ".join(changed[:3])),
            })


def instrument(fn, label: str, donate=()) -> LedgeredFunction:
    """Wrap one capturing callable (a ``to_static`` function) so that its
    captures feed the ledger."""
    return LedgeredFunction(fn, label, donate)


def _on_build(name: str, seconds: float) -> None:
    if bus.enabled():
        bus.emit("backend_compile", {"key": f"nvcc:{name}",
                                     "seconds": round(float(seconds), 3)})


def install_backend_listener() -> None:
    """Emit a ``backend_compile`` row for each kernel build from now on
    (once per process; rows go nowhere while the bus is off)."""
    global _listener_installed
    if _listener_installed:
        return
    _listener_installed = True
    from ..ops.kernels import _build

    _build.BUILD_LISTENERS.append(_on_build)
