"""Utilities of the port: the in-step half of the training guard."""
from . import train_guard

__all__ = ["train_guard"]
