"""paddle.fluid.param_attr — ParamAttr under its 1.x module path
(counterpart of the JAX package's ``paddle/fluid/param_attr.py``).

Reference: python/paddle/fluid/param_attr.py. The object itself is the
port's `nn.ParamAttr`; fluid scripts spell the module path differently,
nothing else.
"""
from paddle_tpu_torch.nn import ParamAttr  # noqa: F401

__all__ = ["ParamAttr", "WeightNormParamAttr"]


class WeightNormParamAttr(ParamAttr):
    """param_attr.py:226 — ParamAttr that also requests weight
    normalization. The reparameterization is applied by the consuming
    layer when it honors `dim`; as a ParamAttr it carries the same
    initializer/regularizer fields."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        super().__init__(
            name=name, initializer=initializer,
            learning_rate=learning_rate, regularizer=regularizer,
            trainable=trainable, need_clip=need_clip,
        )
        self.dim = dim
