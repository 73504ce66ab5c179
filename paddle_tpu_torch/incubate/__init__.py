"""paddle.incubate (counterpart of ``paddle_tpu/incubate``; reference:
python/paddle/fluid/incubate/): ``checkpoint.auto_checkpoint``, the
epoch range that survives preemption. The mixture-of-experts layer
(``moe``, ``ExpertParallelMoE``) is ROADMAP queue A item 7."""
from . import checkpoint  # noqa: F401

__all__ = ["checkpoint"]
