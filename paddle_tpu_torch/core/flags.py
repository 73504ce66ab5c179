"""Global flags (counterpart of ``paddle_tpu/core/flags.py``):
``paddle.set_flags`` / ``paddle.get_flags``, each flag settable from the
environment as ``FLAGS_<name>`` when the module is first imported.

``check_nan_inf`` is the one flag, because it is the one the port acts
on: the eager ops of ``ops/`` and the backward of their results raise
``NanInfError`` naming the op (``core/autograd.py``). A flag of the JAX
package that the port does not act on is not registered, so setting it
raises ``KeyError`` rather than doing nothing.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "set_flags", "get_flags", "flag"]

_REGISTRY: Dict[str, Any] = {}


def define_flag(name: str, default, help_: str = "") -> None:
    env = os.environ.get("FLAGS_" + name)
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _REGISTRY[name] = value


def _key(k: str) -> str:
    return k[6:] if k.startswith("FLAGS_") else k


def set_flags(flags: Dict[str, Any]) -> None:
    """paddle.set_flags({'FLAGS_check_nan_inf': 1}); an unknown flag
    raises ``KeyError``."""
    for k, v in flags.items():
        name = _key(k)
        if name not in _REGISTRY:
            raise KeyError(f"Unknown flag {k}")
        _REGISTRY[name] = v


def get_flags(flags) -> Dict[str, Any]:
    """paddle.get_flags(['FLAGS_check_nan_inf']) -> {name: value}."""
    if isinstance(flags, str):
        flags = [flags]
    return {k: _REGISTRY[_key(k)] for k in flags}


def flag(name: str):
    return _REGISTRY[name]


define_flag("check_nan_inf", False,
            "check every eager op's outputs and gradients for NaN/Inf")
