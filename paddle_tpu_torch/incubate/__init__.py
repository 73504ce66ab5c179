"""paddle.incubate (counterpart of ``paddle_tpu/incubate``; reference:
python/paddle/fluid/incubate/): ``checkpoint.auto_checkpoint``, the
epoch range that survives preemption, and ``moe``, the expert-parallel
mixture-of-experts layer (``ExpertParallelMoE``)."""
from . import checkpoint  # noqa: F401
from . import moe  # noqa: F401
from .moe import ExpertParallelMoE  # noqa: F401

__all__ = ["checkpoint", "moe", "ExpertParallelMoE"]
