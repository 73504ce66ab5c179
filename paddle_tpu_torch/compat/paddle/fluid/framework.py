"""paddle.fluid.framework — graph/mode plumbing in fluid-1.x spellings
(counterpart of the JAX package's ``paddle/fluid/framework.py``).

Reference: python/paddle/fluid/framework.py. The Program/Variable objects
are the port's ``static`` builders; the fluid-era twist is
the *mode default*: a fluid script is static-graph unless it is inside
`fluid.dygraph.guard()`. Rather than flipping the whole process to static
at import (which would break 2.x-style dygraph code sharing the process),
static mode engages lazily the first time a graph-building entry point is
touched (`fluid.data`, `fluid.layers.data`, `program_guard`), and
`dygraph.guard()` forces it off for its scope — the observable fluid
semantics, without a global import side effect.
"""
from __future__ import annotations

import paddle_tpu_torch.static as _static
from paddle_tpu_torch.static import (  # noqa: F401
    Program,
    Variable,
    default_main_program,
    default_startup_program,
)
from paddle_tpu_torch.static import program_guard as _program_guard
from paddle_tpu_torch.core import CPUPlace, CUDAPlace  # noqa: F401

__all__ = [
    "Program", "Variable", "default_main_program",
    "default_startup_program", "program_guard", "in_dygraph_mode",
    "cpu_places", "cuda_places", "name_scope", "_ensure_static",
]


def _ensure_static() -> None:
    """Fluid graph-building entry points imply static mode (a 1.x script
    never calls enable_static — static WAS the default)."""
    if not _static._static_mode_on():
        _static._enable()


def program_guard(main_program, startup_program=None):
    _ensure_static()
    return _program_guard(main_program, startup_program)


def in_dygraph_mode() -> bool:
    return not _static._static_mode_on()


def cpu_places(device_count=None):
    return [CPUPlace()]


def cuda_places(device_ids=None):
    ids = device_ids if device_ids is not None else [0]
    return [CUDAPlace(i) for i in ids]


class _NameScope:
    def __init__(self, prefix):
        self.prefix = prefix

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def name_scope(prefix=None):
    """fluid.name_scope: a debug-visualization grouping; op naming here
    comes from the recorded closures, so the scope is accepted and inert."""
    return _NameScope(prefix)
