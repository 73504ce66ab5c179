"""Core of the port: device resolution and explicit-generator seeding."""
from .device import resolve_device
from .random import generator

__all__ = ["resolve_device", "generator"]
