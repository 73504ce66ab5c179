"""``paddle`` — the port's stock-script package (counterpart of the JAX
package's ``paddle/__init__.py``).

Run a Paddle script verbatim on the port with ``python -m
paddle_tpu_torch.run script.py``: the launcher puts ``compat/`` first on
``sys.path``, so ``import paddle`` loads this package. It is an alias
tree: every public name is the same object as its ``paddle_tpu_torch``
counterpart, and ``sys.modules["paddle.nn"] is
sys.modules["paddle_tpu_torch.nn"]`` (``_alias.py``); the fluid-era
spellings (``fluid.layers.fc``, ``fluid.dygraph.guard``,
``fluid.Executor``) live in the real ``fluid/`` subpackage, mapped onto
the port's facades.

Every file here imports its siblings relatively, so the package also
imports as ``paddle_tpu_torch.compat.paddle`` (a process may hold another
``paddle``); the aliases are installed only when it is imported under the
name ``paddle``.
"""
import paddle_tpu_torch as _pt

from . import _alias as _alias_mod

if __name__ == "paddle":
    _alias_mod.install()

# the full top-level namespace: paddle.add, paddle.Tensor, paddle.nn, ...
# (same objects: enable_static()/set_device() act on the port's state)
globals().update({
    _k: _v for _k, _v in vars(_pt).items()
    if not _k.startswith("__") and _k != "annotations"
})

__version__ = "0.1.0"

# the fluid-era tree is real files, imported last so that it sees a
# finished alias table
from . import fluid  # noqa: E402,F401

__all__ = [k for k in globals() if not k.startswith("_")]
