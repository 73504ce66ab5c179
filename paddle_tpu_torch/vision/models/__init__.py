"""The model zoo (counterparts of ``paddle_tpu/vision/models``): LeNet,
the ResNets, VGG and MobileNet V1/V2, with random weights only."""
from .lenet import LeNet
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = ["LeNet", "MobileNetV1", "MobileNetV2", "mobilenet_v1",
           "mobilenet_v2", "BasicBlock", "BottleneckBlock", "ResNet",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "VGG", "vgg11", "vgg13", "vgg16", "vgg19"]
