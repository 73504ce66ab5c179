"""paddle.fluid — the fluid-era (Paddle 1.x) top-level namespace of the
port's ``paddle`` route (counterpart of the JAX package's
``paddle/fluid/__init__.py``).

Reference: python/paddle/fluid/__init__.py. A 1.x training script touches
this module for places, the Executor, graph entry points (`fluid.data`,
`fluid.layers.*`), the DataFeeder, and `fluid.dygraph`; each submodule
maps the fluid spelling onto the port's facade and shares its objects
(same classes, same static-mode flag, same Programs). The port has CUDA
and CPU places, no TPU ones.

Mode policy (see framework.py): static engages lazily on the first
graph-building call — a 1.x script never calls enable_static — and
`fluid.dygraph.guard()` scopes imperative mode, both restoring cleanly.
"""
from __future__ import annotations

from paddle_tpu_torch.core import CPUPlace, CUDAPlace, Tensor  # noqa: F401
from paddle_tpu_torch.core.flags import get_flags, set_flags  # noqa: F401
from paddle_tpu_torch.static import (  # noqa: F401
    CompiledProgram,
    Executor,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    global_scope,
)

from . import backward  # noqa: F401
from . import core  # noqa: F401
from . import data_feeder  # noqa: F401
from . import dygraph  # noqa: F401
from . import executor  # noqa: F401
from . import framework  # noqa: F401
from . import initializer  # noqa: F401
from . import io  # noqa: F401
from . import layers  # noqa: F401
from . import nets  # noqa: F401
from . import optimizer  # noqa: F401
from . import param_attr  # noqa: F401
from . import regularizer  # noqa: F401
from . import unique_name  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from .core import is_compiled_with_cuda  # noqa: F401
from .executor import Scope, scope_guard  # noqa: F401
from .framework import (  # noqa: F401
    _ensure_static,
    cpu_places,
    cuda_places,
    in_dygraph_mode,
    name_scope,
    program_guard,
)
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401

__all__ = [
    "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "Tensor",
    "Executor", "Program", "Variable", "CompiledProgram",
    "default_main_program", "default_startup_program", "program_guard",
    "global_scope", "scope_guard", "Scope", "DataFeeder", "ParamAttr",
    "WeightNormParamAttr", "data", "embedding", "one_hot",
    "is_compiled_with_cuda", "get_flags",
    "set_flags", "in_dygraph_mode", "enable_dygraph", "disable_dygraph",
    "name_scope", "cpu_places", "cuda_places", "require_version",
    "layers", "nets", "dygraph", "optimizer", "initializer",
    "regularizer", "io", "backward", "framework", "executor", "core",
    "unique_name", "param_attr", "data_feeder",
]

from .core import CUDAPinnedPlace  # noqa: F401,E402
from .dygraph import disable_dygraph, enable_dygraph  # noqa: F401,E402


def data(name, shape, dtype="float32", lod_level=0):
    """fluid.data (fluid/data.py:28): a feed placeholder with the shape
    taken literally (no implicit batch dim — that is layers.data)."""
    import paddle_tpu_torch.static as _static

    _ensure_static()
    return _static.data(name, shape, dtype)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """fluid.embedding (input.py:203) — the 2.0-signature variant that
    does NOT squeeze a trailing [.., 1] id dim (layers.embedding does)."""
    from paddle_tpu_torch.static.nn import embedding as _emb

    return _emb(input, size, is_sparse=is_sparse,
                is_distributed=is_distributed, padding_idx=padding_idx,
                param_attr=param_attr, dtype=dtype)


def one_hot(input, depth, allow_out_of_range=False):
    """fluid.one_hot (input.py:121)."""
    return layers.one_hot(input, depth, allow_out_of_range)


def require_version(min_version, max_version=None):
    """fluid.require_version: scripts gate on the installed Paddle
    version; the route satisfies any requested 1.x/2.x floor."""
    return None
