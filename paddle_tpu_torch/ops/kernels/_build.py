"""Build the port's CUDA sources and bind them with ctypes.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles on first use, with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``, into its own
shared library with a plain C interface under ``paddle_tpu_torch/_build/``
(listed in ``.gitignore``). A library's file name carries a digest of its
sources and flags, so an edited source builds anew and an unchanged one is
loaded as it is. :func:`build` starts one ``nvcc`` per source, all at once.

Every C entry point launches one kernel on the caller's stream and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0 (a refused
launch never runs, and no later synchronize reports it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the ``torch.library`` namespace of the kernels' custom ops
#: (``torch.ops.paddle_tpu_torch.<name>``)
NAMESPACE = "paddle_tpu_torch"

#: dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is missing."""
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's "
        "CUDA kernels build from paddle_tpu_torch/csrc on first use")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start compiling ``csrc/<name>.cu``; None when already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    log = open(out.with_suffix(".log"), "w")
    try:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    except BaseException:
        log.close()
        raise
    return proc, log, tmp, out


#: called with (source name, seconds) after each successful build (the
#: recompile ledger's ``backend_compile`` rows)
BUILD_LISTENERS: List[Callable[[str, float], None]] = []


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile the named sources in parallel (one ``nvcc`` each) and
    return name -> library path. Raises with the compiler's output when
    any build fails."""
    names = list(names)
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    errors = []
    for n, job in jobs.items():
        if job is None:
            continue
        proc, log, tmp, out = job
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
            for listener in BUILD_LISTENERS:
                listener(n, time.perf_counter() - t0)
        else:
            errors.append(f"nvcc failed on csrc/{n}.cu (rc {rc}):\n"
                          + out.with_suffix(".log").read_text())
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: _lib_path(n) for n in names}


def build_log(name: str) -> str:
    """The compiler's output (ptxas register and shared-memory use) of
    the current build of ``csrc/<name>.cu``."""
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def library(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use), with
    ``argtypes`` set from ``signatures`` (function -> ctypes types) and
    every ``restype`` int."""
    lib = _libs.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def count_launch(wrapper, *tensors: torch.Tensor) -> None:
    """One launch of ``wrapper``'s kernel: add one to ``wrapper.launches``
    and to ``wrapper.by_dtype`` under the input types (``"bfloat16"``, or
    ``"float32+bfloat16"`` for addends of two types), and note the first
    input's shape in ``wrapper.shapes``."""
    key = "+".join(dict.fromkeys(str(t.dtype)[6:] for t in tensors))
    wrapper.launches += 1
    wrapper.by_dtype[key] = wrapper.by_dtype.get(key, 0) + 1
    wrapper.shapes.add(tuple(tensors[0].shape))


def stream_ptr(device: torch.device) -> int:
    """The current PyTorch stream of ``device``, as the C interface takes
    it."""
    return torch.cuda.current_stream(device).cuda_stream


def upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the compute type of the kernels' plain versions: float32
    for float32 and narrower types, float64 for float64 (the gradient
    checks run the plain route in float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def refuse_grad(what: str, function: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's outputs carry no autograd graph. Raise, on any
    device, when grad mode is on and an input requires grad: such a call
    goes through ``function`` (a caller of the forward custom op, whose
    registered autograd formula launches the backward kernels)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad and the kernel's outputs would "
            f"be cut from the autograd graph; call it through {function}")


def require_cuda(what: str, *tensors: torch.Tensor) -> torch.device:
    """Check that every tensor lies on one CUDA device, is contiguous and
    has a type the kernels take; return the device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(
                f"{what}: tensors must share one CUDA device, got "
                f"{[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    return dev
