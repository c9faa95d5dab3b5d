"""paddle.nn subset the ported slice runs (counterpart of
paddle_tpu/nn)."""
from torch.nn import ModuleList as LayerList  # noqa: F401

from . import functional, initializer  # noqa: F401
from .layer import Dropout, Embedding, Layer, LayerNorm, Linear  # noqa: F401
