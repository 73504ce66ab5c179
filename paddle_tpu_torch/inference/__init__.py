"""paddle.inference: the deployment predictor (counterpart of
``paddle_tpu/inference/__init__.py``).

Reference: paddle/fluid/inference/api/analysis_predictor.cc: load a saved
program and its parameters and serve them through zero-copy input and
output handles (paddle_infer::Config / create_predictor / Predictor.run).

Here the artifact is ``jit.save``'s (``jit/save_load.py``: a
``torch.export`` program, its weights and its meta record), run by a
``jit.load`` ``TranslatedLayer``; the handle API (names, ``reshape``,
``copy_from_cpu`` / ``copy_to_cpu``) is the reference's, so serving code
ports directly. Inputs are named ``input_<i>`` and outputs ``output_<i>``
(the leaves of the program's output, in order), both known before the
first run: ``get_output_names`` lists every output from the artifact's
meta record, where the JAX package's lists one whatever the count (its
output tree carries no leaf count).

Devices, a named departure: the JAX package's device knobs are inert (XLA
places the program). Here ``Config.disable_gpu()`` is how a caller asks
for the CPU, ``enable_use_gpu(memory_pool_init_size_mb, device_id)``
picks the card ``cuda:<device_id>``, and with neither the predictor runs
on the ``set_device`` default (the card). The other optimization knobs
are accepted and inert, as in the JAX package.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core.tensor import Tensor

__all__ = ["Config", "Predictor", "create_predictor", "Tensor_"]

_MODEL = ".pdmodel"


class Config:
    """paddle_infer.Config: the artifact's path and the device (the
    module docstring); the optimization toggles are accepted and inert."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._path = None
        if prog_file is not None:
            self.set_prog_file(prog_file)
        self._device = None
        self._enable_memory_optim = True
        self._switch_ir_optim = True

    def set_prog_file(self, path):
        self._path = path[:-len(_MODEL)] if path.endswith(_MODEL) else path

    def prog_file(self):
        return self._path

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self) -> bool:
        from ..core.device import resolve_device

        return torch.device(self._device or resolve_device(None)
                            ).type == "cuda"

    def device(self):
        """The device the predictor runs on (None: the ``set_device``
        default)."""
        return self._device

    def enable_memory_optim(self):
        self._enable_memory_optim = True

    def switch_ir_optim(self, flag=True):
        self._switch_ir_optim = flag

    def disable_glog_info(self):
        pass

    def set_cpu_math_library_num_threads(self, n):
        pass


class Tensor_:
    """Input/output handle (paddle_infer.Tensor): stages a host array in,
    reads results out."""

    def __init__(self, name: str, shape=None):
        self.name = name
        self._shape = list(shape) if shape is not None else None
        self._value: Optional[np.ndarray] = None

    def reshape(self, shape):
        self._shape = list(shape)

    def copy_from_cpu(self, arr: np.ndarray):
        self._value = np.ascontiguousarray(arr)
        self._shape = list(arr.shape)

    def copy_to_cpu(self) -> np.ndarray:
        if self._value is None:
            raise RuntimeError(f"handle '{self.name}' holds no data yet")
        return self._value

    def shape(self):
        return self._shape


class Predictor:
    """AnalysisPredictor over a ``jit.save`` artifact."""

    def __init__(self, config: Config):
        from ..jit.save_load import META_SUFFIX, load

        if config.prog_file() is None:
            raise ValueError("Config needs the artifact path (prog_file)")
        self._layer = load(config.prog_file(), device=config.device())
        with open(config.prog_file() + META_SUFFIX) as f:
            meta = json.load(f)
        self._inputs: Dict[str, Tensor_] = {
            f"input_{i}": Tensor_(f"input_{i}", shape)
            for i, (shape, _) in enumerate(meta["input_specs"])}
        self._n_outputs = max(int(meta["n_outputs"]), 1)
        # handles are persistent: fetch-before-run works, run() fills them
        self._outputs: Dict[str, Tensor_] = {}

    def get_input_names(self) -> List[str]:
        return list(self._inputs)

    def get_input_handle(self, name: str) -> Tensor_:
        return self._inputs[name]

    def get_output_names(self) -> List[str]:
        # known from the artifact's meta record before the first run
        return [f"output_{i}" for i in range(self._n_outputs)]

    def get_output_handle(self, name: str) -> Tensor_:
        if name not in self._outputs:
            self._outputs[name] = Tensor_(name)
        return self._outputs[name]

    def run(self) -> bool:
        args = []
        for name, handle in self._inputs.items():
            if handle._value is None:
                raise RuntimeError(f"input '{name}' was not fed")
            args.append(handle._value)
        with torch.no_grad():
            out = self._layer(*args)
        outs = pytree.tree_leaves(out, is_leaf=lambda v: isinstance(
            v, Tensor))
        for i, o in enumerate(outs):
            self.get_output_handle(f"output_{i}").copy_from_cpu(
                o.numpy() if isinstance(o, Tensor) else o.detach().cpu()
                .numpy())
        return True


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
