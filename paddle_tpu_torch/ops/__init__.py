"""The op library of the Paddle surface (counterpart of
``paddle_tpu/ops``): creation, math, manipulation, linear algebra,
logic and search, each taking and returning ``Tensor``; importing it
attaches the operators and methods to ``Tensor`` (``patch``). The
hand-written CUDA kernels live in ``kernels``."""
from . import creation, linalg, logic, manipulation, math, search
from . import patch as _patch  # noqa: F401  (attaches Tensor's methods)
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403

__all__ = (creation.__all__ + linalg.__all__ + logic.__all__
           + manipulation.__all__ + math.__all__ + search.__all__)
