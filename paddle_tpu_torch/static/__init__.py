"""``static`` of the port: static graphs (counterpart of
``paddle_tpu/static``).

``paddle.enable_static()`` switches the package into graph-building mode:
``static.data`` declares a feed placeholder, a symbolic ``Tensor``; each
op or layer that meets one is recorded into the default ``Program``
instead of running (``program.py``); ``opt.minimize(loss)`` records the
backward and update; ``Executor.run(program, feed, fetch_list)`` replays
the recorded ops eagerly on the executor's device (``executor.py``), with
the same backward and update the eager ``minimize`` applies. ``static.nn``
holds the fluid-style layer builders and the control flow.

The JAX package compiles the replay into one XLA program per feed
signature; here the replay is the eager op sequence itself, so a static
program launches the same kernels as the eager step of the same model.
"""
from __future__ import annotations

import sys

from ..core import autograd as _autograd

_STATIC_MODE = False


def _enable():
    global _STATIC_MODE
    _STATIC_MODE = True


def _disable():
    global _STATIC_MODE
    _STATIC_MODE = False


def _static_mode_on() -> bool:
    return _STATIC_MODE


from . import nn  # noqa: E402,F401
from .program import (  # noqa: E402,F401
    Program,
    Variable,
    data,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .executor import (  # noqa: E402,F401
    CompiledProgram,
    Executor,
    global_scope,
)

# the recording hooks of core (autograd.apply, tensor_boundary) read the
# mode through this module
_autograd._static = sys.modules[__name__]

__all__ = [
    "CompiledProgram",
    "Program", "Variable", "data", "default_main_program",
    "default_startup_program", "program_guard", "Executor", "global_scope",
]
