"""paddle.onnx (counterpart of ``paddle_tpu/onnx/__init__.py``).

Reference: python/paddle/onnx/export.py (paddle.onnx.export via
paddle2onnx). The port writes no ONNX: its deployment artifact is
``paddle_tpu_torch.jit.save``'s (a ``torch.export`` program with its
weights), which ``paddle_tpu_torch.inference.Config`` / ``Predictor`` and
``jit.load`` serve. The name stays resolvable and points there instead of
failing with AttributeError, as the JAX package's does."""
from __future__ import annotations

__all__ = ["export"]


def export(layer, path, input_spec=None, opset_version=9, **configs):
    raise NotImplementedError(
        "paddle.onnx.export needs paddle2onnx, which the port does not "
        "have; its deployment artifact is paddle_tpu_torch.jit.save(layer, "
        "path, input_spec=...) (a torch.export program), served by "
        "paddle_tpu_torch.inference.Config/create_predictor or "
        "paddle_tpu_torch.jit.load")
