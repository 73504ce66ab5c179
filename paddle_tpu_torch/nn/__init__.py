"""``nn`` of the port: ``Layer`` and ``ParamAttr``, the initializers, the
gradient clips, and every layer and functional of ``paddle_tpu.nn``, the
recurrent layers (``layers/rnn.py``) and the fluid-era functional tail
(``functional/extras.py``) included. ``nn.common``, ``nn.loss``,
``nn.norm``, ``nn.rnn`` and the other layer modules are importable by
name, as in the JAX package."""
from . import clip, functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Layer, ParamAttr
from .layers import (common, container, conv, loss, norm, pooling,  # noqa
                     rnn, vision)
from .layers import *  # noqa: F401,F403
from .layers import __all__ as _layer_names

__all__ = ["clip", "functional", "initializer", "Layer", "ParamAttr",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "common", "container", "conv", "loss", "norm", "pooling", "rnn",
           "vision"] + _layer_names
