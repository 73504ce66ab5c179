"""Decode and prefill steps of the port (eager PyTorch)."""
from .decode_step import NO_BUDGET, DecodeState, DecodeStep, PrefillStep

__all__ = ["NO_BUDGET", "DecodeState", "DecodeStep", "PrefillStep"]
