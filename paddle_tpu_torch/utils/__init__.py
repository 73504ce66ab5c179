"""Utilities of the port: the training guard (both halves), the
env-spec fault injector (``fault_injection``, standard library only) and
the dataset staging paths (``download``)."""
from . import download, fault_injection, train_guard

__all__ = ["download", "train_guard", "fault_injection"]
