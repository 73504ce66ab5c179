"""``paddle.tensor``: the op families under their module names
(``tensor.creation``, ``tensor.matmul``...), as in the JAX package."""
from ..ops import *  # noqa: F401,F403
from ..ops import (creation, linalg, logic, manipulation,  # noqa: F401
                   math, search)
