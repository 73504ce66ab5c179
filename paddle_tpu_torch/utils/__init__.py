"""Utilities of the port: the in-step half of the training guard, and the
env-spec fault injector (``fault_injection``, standard library only)."""
from . import fault_injection, train_guard

__all__ = ["train_guard", "fault_injection"]
