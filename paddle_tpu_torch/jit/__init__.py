"""Steps of the port (eager PyTorch): decode and prefill for serving, the
training step."""
from .decode_step import NO_BUDGET, DecodeState, DecodeStep, PrefillStep
from .train_step import TrainStep

__all__ = ["NO_BUDGET", "DecodeState", "DecodeStep", "PrefillStep",
           "TrainStep"]
