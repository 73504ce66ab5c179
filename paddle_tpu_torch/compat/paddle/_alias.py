"""Module identity: ``paddle.X`` IS ``paddle_tpu_torch.X`` (counterpart of
the JAX package's ``paddle/_alias.py``).

After ``install()``, ``sys.modules["paddle.nn"] is
sys.modules["paddle_tpu_torch.nn"]``, so classes, functions and
module-level state are single-sourced: there is no second ``Layer``
class to defeat isinstance checks and no copy of mutable state (the
static-mode flag, the device) to drift.

Two mechanisms:
  1. ``install()`` aliases every ``paddle_tpu_torch.*`` module already in
     ``sys.modules`` (importing the port pulls in its public tree).
  2. ``_AliasFinder``, at the FRONT of ``sys.meta_path``, resolves any
     later ``import paddle.x.y`` to ``paddle_tpu_torch.x.y``. It must run
     before the stock PathFinder, which would otherwise execute a
     not-yet-imported submodule's file a second time under the
     ``paddle.`` name. It defers (returns None) exactly for names that
     are real files under this package's directory (the fluid tree),
     so those still win.
"""
from __future__ import annotations

import importlib
import importlib.abc
import importlib.machinery
import importlib.util
import os
import sys

_SRC = "paddle_tpu_torch"
_DST = "paddle"
_PKG_DIR = os.path.dirname(os.path.abspath(__file__))


def _is_real_file(suffix: str) -> bool:
    """True when <this package>/<suffix as path> exists on disk (the fluid
    tree): those modules belong to PathFinder, not the alias."""
    rel = os.path.join(_PKG_DIR, *suffix.split("."))
    return os.path.exists(rel + ".py") or \
        os.path.exists(os.path.join(rel, "__init__.py"))


def _alias_name(fullname: str):
    """'paddle.x.y' -> 'paddle_tpu_torch.x.y', or None if not aliasable."""
    if not fullname.startswith(_DST + "."):
        return None
    suffix = fullname[len(_DST) + 1:]
    if _is_real_file(suffix):
        return None
    return _SRC + "." + suffix


class _AliasLoader(importlib.abc.Loader):
    def __init__(self, target: str):
        self._target = target

    def create_module(self, spec):
        # the EXISTING module object of the port: exact identity
        return importlib.import_module(self._target)

    def exec_module(self, module):
        pass  # already executed under its real name


class _AliasFinder(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        tgt = _alias_name(fullname)
        if tgt is None:
            return None
        try:
            t_spec = importlib.util.find_spec(tgt)
        except (ImportError, ValueError):
            return None
        if t_spec is None:
            return None
        return importlib.machinery.ModuleSpec(
            fullname,
            _AliasLoader(tgt),
            is_package=t_spec.submodule_search_locations is not None,
        )


def install() -> None:
    importlib.import_module(_SRC)  # materializes the module tree
    for name in sorted(k for k in list(sys.modules)
                       if k.startswith(_SRC + ".")):
        mod = sys.modules[name]
        if mod is None:
            continue
        sys.modules.setdefault(_DST + name[len(_SRC):], mod)
    if not any(isinstance(f, _AliasFinder) for f in sys.meta_path):
        sys.meta_path.insert(0, _AliasFinder())
