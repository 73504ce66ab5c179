"""The ResNet family (counterpart of
``paddle_tpu/vision/models/resnet.py``): ``BasicBlock``,
``BottleneckBlock``, ``ResNet`` and ``resnet18/34/50/101/152``, with random
weights only (``pretrained=True`` raises: the port downloads nothing)."""
from __future__ import annotations

from torch import nn

from ... import nn as pnn
from ...ops.manipulation import flatten
from ._device import placement

__all__ = ["BasicBlock", "BottleneckBlock", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152"]


class BasicBlock(nn.Module):
    """Two 3 x 3 convolutions with batch norm, and the residual sum."""

    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device,
                 generator):
        super().__init__()
        norm_layer = norm_layer or pnn.BatchNorm2D
        kw = dict(device=device, generator=generator)
        self.conv1 = pnn.Conv2D(inplanes, planes, 3, padding=1,
                                stride=stride, bias_attr=False, **kw)
        self.bn1 = norm_layer(planes, device=device)
        self.relu = pnn.ReLU()
        self.conv2 = pnn.Conv2D(planes, planes, 3, padding=1,
                                bias_attr=False, **kw)
        self.bn2 = norm_layer(planes, device=device)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    """1 x 1, 3 x 3 (with the stride) and 1 x 1 convolutions with batch
    norm, and the residual sum."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None, *, device,
                 generator):
        super().__init__()
        norm_layer = norm_layer or pnn.BatchNorm2D
        kw = dict(device=device, generator=generator)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = pnn.Conv2D(inplanes, width, 1, bias_attr=False, **kw)
        self.bn1 = norm_layer(width, device=device)
        self.conv2 = pnn.Conv2D(width, width, 3, padding=dilation,
                                stride=stride, groups=groups,
                                dilation=dilation, bias_attr=False, **kw)
        self.bn2 = norm_layer(width, device=device)
        self.conv3 = pnn.Conv2D(width, planes * self.expansion, 1,
                                bias_attr=False, **kw)
        self.bn3 = norm_layer(planes * self.expansion, device=device)
        self.relu = pnn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """ResNet of ``depth`` (18, 34, 50, 101, 152) from ``block``: a 7 x 7
    stem with max pooling, four stages, average pooling and a Linear
    classifier. Weights are drawn from ``generator`` on ``device`` (CUDA
    unless the caller passes ``"cpu"``)."""

    def __init__(self, block, depth, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        layers = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                  101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}[depth]
        dev, gen = placement(device, generator)
        kw = dict(device=dev, generator=gen)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self._norm_layer = pnn.BatchNorm2D
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = pnn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                                bias_attr=False, **kw)
        self.bn1 = self._norm_layer(self.inplanes, device=dev)
        self.relu = pnn.ReLU()
        self.maxpool = pnn.MaxPool2D(3, 2, 1)
        self.layer1 = self._make_layer(block, 64, layers[0], kw=kw)
        self.layer2 = self._make_layer(block, 128, layers[1], 2, kw=kw)
        self.layer3 = self._make_layer(block, 256, layers[2], 2, kw=kw)
        self.layer4 = self._make_layer(block, 512, layers[3], 2, kw=kw)
        if with_pool:
            self.avgpool = pnn.AdaptiveAvgPool2D((1, 1))
        if num_classes > 0:
            self.fc = pnn.Linear(512 * block.expansion, num_classes, **kw)

    def _make_layer(self, block, planes, blocks, stride=1, *, kw):
        norm_layer = self._norm_layer
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = pnn.Sequential(
                pnn.Conv2D(self.inplanes, planes * block.expansion, 1,
                           stride=stride, bias_attr=False, **kw),
                norm_layer(planes * block.expansion, device=kw["device"]),
            )
        layers = [block(self.inplanes, planes, stride, downsample, 1, 64,
                        self.dilation, norm_layer, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, norm_layer=norm_layer,
                                **kw))
        return pnn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def _resnet(block, depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights: the port downloads nothing; load a "
            "checkpoint with load_state_dict")
    return ResNet(block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)
