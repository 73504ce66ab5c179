"""Device and generator of a model zoo entry point."""
from __future__ import annotations

from ...core.device import resolve_device
from ...core.random import generator as make_generator


def placement(device, generator):
    """``device`` resolved (CUDA unless the caller passes the CPU) and
    the generator the weights are drawn from (seeded with 0 when the
    caller passes none)."""
    dev = resolve_device(device)
    return dev, generator if generator is not None \
        else make_generator(0, dev)
