"""nn.vision (reference python/paddle/nn/layer/vision.py row:
PixelShuffle lives there)."""
from .layer.common import PixelShuffle  # noqa: F401

__all__ = ["PixelShuffle"]
