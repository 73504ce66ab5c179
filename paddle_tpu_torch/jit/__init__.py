"""Steps of the port (eager PyTorch): decode, prefill and the speculative
round for serving, the training step; and the quantized weight
checkpoints."""
from .decode_step import (
    NO_BUDGET, DecodeState, DecodeStep, PrefillStep, SpecDecodeState,
    SpeculativeDecodeStep, spec_k_default,
)
from .save_load import load_quantized, save_quantized
from .train_step import TrainStep

__all__ = ["NO_BUDGET", "DecodeState", "DecodeStep", "PrefillStep",
           "SpecDecodeState", "SpeculativeDecodeStep", "spec_k_default",
           "save_quantized", "load_quantized", "TrainStep"]
