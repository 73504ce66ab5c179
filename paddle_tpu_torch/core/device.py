"""Device selection (counterpart of ``paddle_tpu/core/device.py``).

The port runs on the card: an entry point given no device takes the
package default, which is ``cuda`` until ``set_device`` names another
(``set_device("cpu")``, as the tests do). There is no fallback: asking for
CUDA on a host without a CUDA device raises, in ``set_device`` and in
``resolve_device`` alike.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "Place", "CPUPlace", "CUDAPlace", "set_device",
           "get_device", "is_compiled_with_cuda"]

# the package default, None = cuda (set_device writes it)
_current: Optional[torch.device] = None


class Place:
    """A place tag, ``paddle.CPUPlace()`` / ``paddle.CUDAPlace(i)``: the
    kind (``"cpu"`` or ``"gpu"``) and the index, hashable."""

    def __init__(self, kind: str, index: int = 0):
        self.kind = kind
        self.index = int(index)

    def torch_device(self) -> torch.device:
        return torch.device("cpu") if self.kind == "cpu" \
            else torch.device("cuda", self.index)

    def __repr__(self):
        return f"Place({self.kind}:{self.index})"

    def __eq__(self, other):
        return isinstance(other, Place) and (self.kind, self.index) == (
            other.kind, other.index)

    def __hash__(self):
        return hash((self.kind, self.index))


def CPUPlace() -> Place:
    return Place("cpu", 0)


def CUDAPlace(index: int = 0) -> Place:
    return Place("gpu", index)


def _check(dev: torch.device) -> torch.device:
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: the port runs on cuda, "
                         "or on the cpu when asked")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu' (or calls set_device('cpu'))")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_device(device: Optional[Union[str, torch.device, Place]] = None
                   ) -> torch.device:
    """``None`` -> the package default (``set_device``; the current CUDA
    device until then); ``"cpu"`` -> the CPU; any CUDA spelling (``"gpu"``
    too) -> that CUDA device. Raises when CUDA is asked for and absent,
    or for another device type."""
    if device is None:
        return _check(_current if _current is not None
                      else torch.device("cuda"))
    if isinstance(device, Place):
        return _check(device.torch_device())
    if isinstance(device, str) and device.startswith("gpu"):
        device = "cuda" + device[3:]
    return _check(torch.device(device))


def set_device(device) -> Place:
    """paddle.set_device('gpu' | 'gpu:N' | 'cpu' | a Place): the device of
    every later call that names none. ``'tpu'`` and other kinds raise, and
    so does a CUDA device on a host without one."""
    global _current
    if isinstance(device, Place):
        kind, idx = device.kind, device.index
    else:
        name = str(device)
        kind, _, idx = name.partition(":")
        idx = int(idx) if idx else 0
    kind = {"cuda": "gpu"}.get(kind, kind)
    if kind not in ("cpu", "gpu"):
        raise ValueError(f"set_device({device!r}): the port runs on 'gpu' "
                         "or 'cpu'")
    _current = _check(Place(kind, idx).torch_device())
    return Place(kind, idx if kind == "gpu" else 0)


def get_device() -> str:
    """paddle.get_device: ``"gpu:N"`` or ``"cpu"``."""
    dev = _current if _current is not None else torch.device("cuda", 0)
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"


def is_compiled_with_cuda() -> bool:
    """The port is the CUDA build."""
    return True
