"""The VGG family (counterpart of ``paddle_tpu/vision/models/vgg.py``),
with random weights only (``pretrained=True`` raises: the port downloads
nothing)."""
from __future__ import annotations

from ... import nn as pnn
from ...core.device import resolve_device
from ...nn.layer import Layer
from ...nn.layers.common import flatten

__all__ = ["VGG", "make_layers", "vgg11", "vgg13", "vgg16", "vgg19"]

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512,
          512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512,
          "M", 512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512,
          512, 512, "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False, *, device=None, generator=None):
    """The convolutional trunk of ``cfg``: 3 x 3 convolutions (with batch
    norm when asked) and ReLU, 2 x 2 max pooling at each ``"M"``."""
    dev = resolve_device(device)
    kw = dict(device=dev, generator=generator)
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(pnn.MaxPool2D(2, 2))
        else:
            conv = pnn.Conv2D(in_channels, v, 3, padding=1, **kw)
            if batch_norm:
                layers += [conv, pnn.BatchNorm2D(v, device=dev), pnn.ReLU()]
            else:
                layers += [conv, pnn.ReLU()]
            in_channels = v
    return pnn.Sequential(*layers)


class VGG(Layer):
    """``features``, then 7 x 7 adaptive average pooling and the 3-layer
    classifier (dropout 0.5 between). Weights are drawn from ``generator``
    (the package's when None) on ``device`` (the ``set_device`` default
    when None); the dropout masks from the package's generator."""

    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = pnn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                pnn.Linear(512 * 7 * 7, 4096, **kw),
                pnn.ReLU(),
                pnn.Dropout(),
                pnn.Linear(4096, 4096, **kw),
                pnn.ReLU(),
                pnn.Dropout(),
                pnn.Linear(4096, num_classes, **kw),
            )

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _vgg(arch, cfg, batch_norm, pretrained, device=None, generator=None,
         **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights: the port downloads nothing; load a "
            "checkpoint with set_state_dict")
    return VGG(make_layers(cfgs[cfg], batch_norm, device=device,
                           generator=generator),
               device=device, generator=generator, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg11", "A", batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg13", "B", batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg16", "D", batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("vgg19", "E", batch_norm, pretrained, **kwargs)
