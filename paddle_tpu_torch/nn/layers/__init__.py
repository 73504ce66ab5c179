"""The layers of ``nn`` (counterparts of ``paddle_tpu/nn/layers``), each
module's ``__all__`` re-exported, the recurrent layers (``rnn.py``)
among them."""
from . import (activation, common, container, conv, loss, norm, pooling,
               rnn, transformer, vision)
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

__all__ = [name for mod in (activation, common, container, conv, loss, norm,
                            pooling, rnn, transformer)
           for name in mod.__all__]
