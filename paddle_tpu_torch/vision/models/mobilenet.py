"""MobileNet V1 and V2 (counterpart of
``paddle_tpu/vision/models/mobilenet.py``; reference:
python/paddle/vision/models/mobilenetv1.py, mobilenetv2.py), with random
weights only (``pretrained=True`` raises). Weights are drawn from
``generator`` (the package's when None) on ``device`` (the
``set_device`` default when None)."""
from __future__ import annotations

from ... import nn as pnn
from ...core.device import resolve_device
from ...nn.layer import Layer
from ...nn.layers.common import flatten

__all__ = ["MobileNetV1", "MobileNetV2", "mobilenet_v1", "mobilenet_v2"]


class ConvBNLayer(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, groups=1, act="relu", *, device, generator):
        super().__init__()
        self.conv = pnn.Conv2D(in_channels, out_channels, kernel_size,
                               stride=stride, padding=padding, groups=groups,
                               bias_attr=False, device=device,
                               generator=generator)
        self.bn = pnn.BatchNorm2D(out_channels, device=device)
        self.act = pnn.ReLU6() if act == "relu6" else (
            pnn.ReLU() if act else None)

    def forward(self, x):
        x = self.bn(self.conv(x))
        return self.act(x) if self.act else x


class DepthwiseSeparable(Layer):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups,
                 stride, scale, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.dw = ConvBNLayer(in_channels, int(out_channels1 * scale), 3,
                              stride=stride, padding=1,
                              groups=int(num_groups * scale), **kw)
        self.pw = ConvBNLayer(int(out_channels1 * scale),
                              int(out_channels2 * scale), 1, **kw)

    def forward(self, x):
        return self.pw(self.dw(x))


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        s = scale
        self.conv1 = ConvBNLayer(3, int(32 * s), 3, stride=2, padding=1,
                                 **kw)
        cfg = [
            (32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
            (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
            (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1),
            (512, 512, 1024, 512, 2), (1024, 1024, 1024, 1024, 1),
        ]
        self.blocks = pnn.Sequential(*[
            DepthwiseSeparable(int(in_c * s), c1, c2, g, st, s, **kw)
            for in_c, c1, c2, g, st in cfg])
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = pnn.Linear(int(1024 * s), num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


class InvertedResidual(Layer):
    def __init__(self, inp, oup, stride, expand_ratio, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.stride = stride
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNLayer(inp, hidden, 1, act="relu6", **kw))
        layers += [
            ConvBNLayer(hidden, hidden, 3, stride=stride, padding=1,
                        groups=hidden, act="relu6", **kw),
            ConvBNLayer(hidden, oup, 1, act=None, **kw),
        ]
        self.conv = pnn.Sequential(*layers)

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


def _make_divisible(v, divisor=8, min_value=None):
    min_value = min_value or divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class MobileNetV2(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        cfg = [
            (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
        ]
        input_channel = _make_divisible(32 * scale)
        last_channel = _make_divisible(1280 * max(1.0, scale))
        features = [ConvBNLayer(3, input_channel, 3, stride=2, padding=1,
                                act="relu6", **kw)]
        for t, c, n, s in cfg:
            out_c = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, out_c, s if i == 0 else 1, t, **kw))
                input_channel = out_c
        features.append(ConvBNLayer(input_channel, last_channel, 1,
                                    act="relu6", **kw))
        self.features = pnn.Sequential(*features)
        if with_pool:
            self.pool = pnn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = pnn.Sequential(
                pnn.Dropout(0.2), pnn.Linear(last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights: the port downloads nothing; load a "
            "checkpoint with set_state_dict")
    return MobileNetV1(scale=scale, **kwargs)


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights: the port downloads nothing; load a "
            "checkpoint with set_state_dict")
    return MobileNetV2(scale=scale, **kwargs)
