"""``nn.vision`` (counterpart of ``paddle_tpu/nn/layers/vision.py``): the
module name under which upstream Paddle keeps ``PixelShuffle``."""
from .common import PixelShuffle

__all__ = ["PixelShuffle"]
