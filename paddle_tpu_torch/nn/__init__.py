"""paddle.nn subset the ported slice runs (counterpart of
paddle_tpu/nn)."""
from torch.nn import ModuleList as LayerList  # noqa: F401

from . import clip, functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import (Dropout, Embedding, Layer, LayerNorm,  # noqa: F401
                    Linear, ScannedStack)
