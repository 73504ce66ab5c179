"""LeNet-5 (counterpart of ``paddle_tpu/vision/models/lenet.py``)."""
from __future__ import annotations

from torch import nn

from ... import nn as pnn
from ...ops.manipulation import flatten
from ._device import placement

__all__ = ["LeNet"]


class LeNet(nn.Module):
    """LeNet for 28 x 28 single-channel input (MNIST): two convolutions
    with ReLU and 2 x 2 max pooling, then three Linear layers. Weights are
    drawn from ``generator`` on ``device`` (CUDA unless the caller passes
    ``"cpu"``)."""

    def __init__(self, num_classes=10, *, device=None, generator=None):
        super().__init__()
        dev, gen = placement(device, generator)
        kw = dict(device=dev, generator=gen)
        self.num_classes = num_classes
        self.features = pnn.Sequential(
            pnn.Conv2D(1, 6, 3, stride=1, padding=1, **kw),
            pnn.ReLU(),
            pnn.MaxPool2D(2, 2),
            pnn.Conv2D(6, 16, 5, stride=1, padding=0, **kw),
            pnn.ReLU(),
            pnn.MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = pnn.Sequential(
                pnn.Linear(400, 120, **kw),
                pnn.Linear(120, 84, **kw),
                pnn.Linear(84, num_classes, **kw),
            )

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x
