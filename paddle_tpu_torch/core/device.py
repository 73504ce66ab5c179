"""Device resolution for the port's entry points.

The port runs on the card: an entry point given no device takes ``cuda``,
and takes the CPU only when the caller names it (``device="cpu"``, as the
tests do). There is no fallback: asking for CUDA on a host without a CUDA
device raises.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> the current CUDA device; ``"cpu"`` -> the CPU; any CUDA
    spelling -> that CUDA device. Raises when CUDA is asked for and
    absent, or for another device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: the port runs on cuda, "
                         "or on the cpu when asked")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
