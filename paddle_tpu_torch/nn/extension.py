"""nn.extension (reference python/paddle/nn/extension row)."""
from .functional.extension import diag_embed  # noqa: F401

__all__ = ["diag_embed"]
