"""The common layers (counterparts of ``paddle_tpu/nn/layers/common.py``),
with its arguments in its order: ``Linear``, ``Embedding``, the dropouts,
``Flatten``, ``Identity``, the upsampling and padding layers,
``CosineSimilarity``, ``PairwiseDistance``, ``Bilinear``, ``PixelShuffle``
and ``Unfold``.

Weights are paddle's layout: ``Linear.weight`` is ``[in, out]``, as in
the JAX package, so its ``state_dict()`` loads with no transposes. The
initializers are paddle's: XavierNormal weights, zero bias, drawn from
``generator`` (the package's generator of ``device``, which
``paddle.seed`` seeds, when None). ``device`` is the ``set_device``
default when None, ``dtype`` the default float type.
"""
from __future__ import annotations

import math

import torch

from ...ops.manipulation import pad
from ..functional import common as C
from ..functional.common import dropout, linear
from ..initializer import Uniform, XavierNormal
from ..layer import Layer

__all__ = [
    "Linear", "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout",
    "Embedding", "Flatten", "Identity", "Upsample", "UpsamplingBilinear2D",
    "UpsamplingNearest2D", "Pad1D", "Pad2D", "Pad3D", "CosineSimilarity",
    "Bilinear", "PixelShuffle", "Unfold", "PairwiseDistance",
]


class Linear(Layer):
    """y = x W + b with W ``[in_features, out_features]``, through
    ``functional.linear`` (the AMP cast site)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None,
                 generator=None):
        super().__init__(dtype=dtype)
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        kw = dict(device=device, generator=generator)
        self.weight = self.create_parameter(
            [in_features, out_features], weight_attr,
            default_initializer=XavierNormal(), **kw)
        self.bias = self.create_parameter([out_features], bias_attr,
                                          is_bias=True, **kw)

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in_features={self.in_features}, " \
               f"out_features={self.out_features}"


class Embedding(Layer):
    """Row lookup in a ``[num_embeddings, embedding_dim]`` table; ids equal
    to ``padding_idx`` (when given; a negative one counts from the end)
    look up zeros and send no gradient, and that row starts at zeros.
    ``sparse`` is taken and the gradient is dense, as in the JAX
    package."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        self._padding_idx = None if padding_idx is None \
            else padding_idx % num_embeddings
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], weight_attr,
            default_initializer=XavierNormal(), device=device,
            generator=generator)
        if self._padding_idx is not None:
            with torch.no_grad():
                self.weight[self._padding_idx] = 0

    def forward(self, ids):
        return C.embedding(ids, self.weight, self._padding_idx)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Dropout(Layer):
    """``functional.dropout`` in training, the identity (or the
    ``downscale_in_infer`` scaling) in eval; the mask comes from
    ``generator`` (the package's generator of the input's device when
    None)."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None,
                 *, generator=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self._generator = generator

    def forward(self, x):
        return dropout(x, self.p, axis=self.axis, training=self.training,
                       mode=self.mode, generator=self._generator)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


def flatten(x, start_axis=0, stop_axis=-1):
    """Merge the axes ``start_axis..stop_axis`` (inclusive) of a
    ``torch.Tensor`` into one (a 0-d tensor becomes ``[1]``)."""
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


class Flatten(Layer):
    """Merge the axes ``start_axis..stop_axis`` into one."""

    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)


class Dropout2D(Layer):
    """Whole channels dropped in training (``functional.dropout2d``)."""

    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator=None):
        super().__init__()
        self.p, self.data_format = p, data_format
        self._generator = generator

    def forward(self, x):
        return C.dropout2d(x, self.p, self.training, self.data_format,
                           generator=self._generator)


class Dropout3D(Dropout2D):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator=None):
        super().__init__(p, data_format, generator=generator)

    def forward(self, x):
        return C.dropout3d(x, self.p, self.training, self.data_format,
                           generator=self._generator)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None, *, generator=None):
        super().__init__()
        self.p, self._generator = p, generator

    def forward(self, x):
        return C.alpha_dropout(x, self.p, self.training,
                               generator=self._generator)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class Upsample(Layer):
    """``functional.interpolate`` with the options given (the JAX
    package's function: ``align_corners`` and ``align_mode`` have no
    effect)."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor, self.mode = size, scale_factor, mode
        self.align_corners, self.align_mode = align_corners, align_mode
        self.data_format = data_format

    def forward(self, x):
        return C.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest",
                         data_format=data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True,
                         data_format=data_format)


class Pad2D(Layer):
    """``paddle.pad`` with the options given (``Pad1D``: NCL, ``Pad3D``:
    NCDHW by default)."""

    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding, self.mode, self.value = padding, mode, value
        self.data_format = data_format

    def forward(self, x):
        return pad(x, self.padding, self.mode, self.value,
                   self.data_format)._data


class Pad1D(Pad2D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(Pad2D):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return C.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    """``sum(|x - y + epsilon|^p)^(1/p)`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon = float(p), float(epsilon)
        self.keepdim = keepdim

    def forward(self, x, y):
        d = (x - y + self.epsilon).abs() ** self.p
        return d.sum(dim=-1, keepdim=self.keepdim) ** (1.0 / self.p)


class Bilinear(Layer):
    """``x1 W x2 + b`` with ``W`` ``[out, in1, in2]`` and ``b`` ``[out]``,
    both Uniform(-k, k), ``k = 1 / sqrt(in1)``."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *, device=None,
                 dtype=None, generator=None):
        super().__init__(dtype=dtype)
        k = 1.0 / math.sqrt(in1_features)
        kw = dict(device=device, generator=generator,
                  default_initializer=Uniform(-k, k))
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], weight_attr, **kw)
        self.bias = self.create_parameter([out_features], bias_attr,
                                          is_bias=True, **kw)

    def forward(self, x1, x2):
        return C.bilinear(x1, x2, self.weight, self.bias)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return C.pixel_shuffle(x, self.upscale_factor, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.kernel_sizes, self.strides = kernel_sizes, strides
        self.paddings, self.dilations = paddings, dilations

    def forward(self, x):
        return C.unfold(x, self.kernel_sizes, self.strides, self.paddings,
                        self.dilations)
