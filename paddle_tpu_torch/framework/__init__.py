"""``framework`` of the port: ``paddle.save`` / ``paddle.load``."""
from . import io
from .io import crc32_file, load, save

__all__ = ["io", "crc32_file", "load", "save"]
