"""The native host-staging library and its ctypes bindings (counterpart of
``paddle_tpu/native/__init__.py``).

``csrc/staging.cpp`` is host C++, the collation of the input pipeline
(not a device kernel). It builds at first use with ``g++ -O3
-march=native -shared -fPIC -std=c++17 -pthread`` into
``paddle_tpu_torch/_build/`` (git-ignored). The file name carries a digest
of the source, the flags and the host's CPU (``-march=native`` code does
not move between CPUs), so an edited source or another host builds anew.

``stack_samples`` and ``stack_u8_to_f32`` run the library when it loaded
and numpy otherwise (their plain versions, also taken below
``_MIN_NATIVE_BYTES`` by ``stack_samples``, where threads cost more than
they save); ``available()`` says which. Every call is counted by the route
it took (``calls()``); a process-worker loader adds its workers' counts
to the parent's (``io/dataloader.py``), so a caller can check that its
batches went through the library.
"""
from __future__ import annotations

import copy
import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["available", "stack_samples", "stack_u8_to_f32", "lib",
           "build_error", "calls", "reset_calls"]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "staging.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False
_ERROR: Optional[str] = None
_DEFAULT_THREADS = min(8, os.cpu_count() or 1)

_COUNT_LOCK = threading.Lock()
_calls = {"stack_samples": {"native": 0, "numpy": 0},
          "stack_u8_to_f32": {"native": 0, "numpy": 0}}


def _host_tag() -> bytes:
    """The CPU's model name and feature flags (what ``-march=native``
    compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            keep = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(keep))).encode()
    except OSError:
        return f"{platform.machine()} {platform.processor()}".encode()


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_SRC.read_bytes())
    h.update(_host_tag())
    return BUILD_DIR / f"libptstaging-{h.hexdigest()[:12]}.so"


def _build() -> Path:
    so = _lib_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, str(_SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on csrc/staging.cpp "
                           f"(rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)  # atomic under concurrent builders
    return so


def lib():
    """The loaded library, or None when it could not be built or loaded
    (``build_error()`` says why)."""
    global _LIB, _TRIED, _ERROR
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            L = ctypes.CDLL(str(_build()))
            L.pt_stack.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ]
            L.pt_stack_u8_to_f32.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
                ctypes.c_float, ctypes.c_int,
            ]
            L.pt_version.restype = ctypes.c_int
            if L.pt_version() != 1:
                raise RuntimeError(f"staging library version "
                                   f"{L.pt_version()}, expected 1")
            _LIB = L
        except Exception as e:  # no toolchain: the numpy route, reported
            _ERROR = f"{type(e).__name__}: {e}"
            _LIB = None
    return _LIB


def available() -> bool:
    return lib() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (None when it is, or before the
    first try)."""
    return _ERROR


def calls() -> dict:
    """Calls of ``stack_samples`` / ``stack_u8_to_f32`` by route
    (``"native"`` or ``"numpy"``), this process's and its process-worker
    loaders'."""
    with _COUNT_LOCK:
        return copy.deepcopy(_calls)


def reset_calls() -> None:
    with _COUNT_LOCK:
        for routes in _calls.values():
            for r in routes:
                routes[r] = 0


def _take_calls() -> dict:
    """The counts so far, then zero (a worker ships them with a batch)."""
    with _COUNT_LOCK:
        out = copy.deepcopy(_calls)
        for routes in _calls.values():
            for r in routes:
                routes[r] = 0
    return out


def _add_calls(counts: dict) -> None:
    with _COUNT_LOCK:
        for fn, routes in counts.items():
            for r, n in routes.items():
                _calls[fn][r] += n


def _count(fn: str, route: str) -> None:
    with _COUNT_LOCK:
        _calls[fn][route] += 1


def _src_ptrs(samples):
    arr = (ctypes.c_void_p * len(samples))()
    for i, s in enumerate(samples):
        arr[i] = s.ctypes.data
    return arr


# below this, thread spawn/join overhead beats the memcpy win
_MIN_NATIVE_BYTES = 1 << 20


def stack_samples(samples) -> np.ndarray:
    """np.stack of same-shape, same-dtype contiguous arrays, done by the
    native library (GIL released during the copies). Small batches
    (< ~1MB) go straight to np.stack: thread startup would dominate."""
    L = lib()
    first = samples[0]
    total = first.nbytes * len(samples)
    if L is None or total < _MIN_NATIVE_BYTES:
        _count("stack_samples", "numpy")
        return np.stack(samples)
    out = np.empty((len(samples),) + first.shape, first.dtype)
    threads = _DEFAULT_THREADS if total >= 8 * _MIN_NATIVE_BYTES else 2
    L.pt_stack(
        out.ctypes.data, _src_ptrs(samples), len(samples),
        first.nbytes, threads,
    )
    _count("stack_samples", "native")
    return out


def stack_u8_to_f32(samples, scale: float = 1.0 / 255.0,
                    shift: float = 0.0) -> np.ndarray:
    """Fused stack + uint8 -> float32 ``x * scale + shift`` (the vision
    transform's hot loop: ToTensor's /255)."""
    L = lib()
    first = samples[0]
    if L is None:
        _count("stack_u8_to_f32", "numpy")
        return np.stack(samples).astype(np.float32) * scale + shift
    out = np.empty((len(samples),) + first.shape, np.float32)
    L.pt_stack_u8_to_f32(
        out.ctypes.data, _src_ptrs(samples), len(samples),
        first.size, scale, shift, _DEFAULT_THREADS,
    )
    _count("stack_u8_to_f32", "native")
    return out
