"""paddle.fluid.io — 1.x checkpoint/reader spellings (counterpart of the
JAX package's ``paddle/fluid/io.py``).

Reference: python/paddle/fluid/io.py (save_params/save_persistables over
Program variables) and fluid/reader.py (DataLoader). Static-graph state
here is the live Parameter objects the Program leaves resolve to, so
"save the persistables of a program" is the program's parameter leaves as
a state dict through the port's ``save``/``load`` (the JAX package's
checkpoint format). The inference-model pair refuses with the JAX
package's message.
"""
from __future__ import annotations

import os

import paddle_tpu_torch as _P
from paddle_tpu_torch.io import DataLoader  # noqa: F401
from paddle_tpu_torch.batch import batch  # noqa: F401

__all__ = [
    "DataLoader", "batch", "save", "load", "save_params", "load_params",
    "save_persistables", "load_persistables", "save_inference_model",
    "load_inference_model",
]

save = _P.save
load = _P.load


def _program_params(main_program=None):
    from paddle_tpu_torch.static import default_main_program

    prog = main_program or default_main_program()
    out = {}
    for i, p in enumerate(prog.all_parameters()):
        out[p.name or f"param_{i}"] = p
    return out


def save_params(executor, dirname, main_program=None, filename=None):
    """io.py:117 save_params: the program's parameter leaves."""
    params = _program_params(main_program)
    os.makedirs(dirname, exist_ok=True)
    target = os.path.join(dirname, filename or "params.pdparams")
    _P.save({k: v for k, v in params.items()}, target)


def load_params(executor, dirname, main_program=None, filename=None):
    params = _program_params(main_program)
    target = os.path.join(dirname, filename or "params.pdparams")
    loaded = _P.load(target)
    for k, v in params.items():
        if k in loaded:
            v.set_value(loaded[k])


# persistables == params + opt state; state is live objects here, the
# same leaves cover both spellings
save_persistables = save_params
load_persistables = load_params


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, **kw):
    """io.py:1002: the deployment artifact. Refused, as the JAX package
    refuses it (a fluid Program-desc file has no interpreter here),
    pointing at the port's artifact as its message points at its own."""
    raise NotImplementedError(
        "fluid.io.save_inference_model is out of scope: export programs "
        "with paddle.jit.save (a torch.export program), served by "
        "paddle.jit.load and paddle.inference"
    )


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    raise NotImplementedError(
        "fluid.io.load_inference_model is out of scope: load "
        "paddle.jit.save artifacts with paddle.jit.load"
    )
