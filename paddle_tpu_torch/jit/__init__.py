"""Steps of the port (eager PyTorch): decode, prefill, the migrated-KV
insert and the speculative round for serving, the training step; the
quantized weight checkpoints; and the control flow (``cond``, ``case``,
``switch_case``, ``while_loop``, ``scan``)."""
from . import control_flow
from .control_flow import case, cond, scan, switch_case, while_loop
from .decode_step import (
    NO_BUDGET, DecodeState, DecodeStep, MigrateInsert, PrefillStep,
    SpecDecodeState, SpeculativeDecodeStep, spec_k_default,
)
from .save_load import load_quantized, save_quantized
from .train_step import TrainStep

__all__ = ["NO_BUDGET", "DecodeState", "DecodeStep", "PrefillStep",
           "MigrateInsert",
           "SpecDecodeState", "SpeculativeDecodeStep", "spec_k_default",
           "save_quantized", "load_quantized", "TrainStep", "control_flow",
           "case", "cond", "scan", "switch_case", "while_loop"]
