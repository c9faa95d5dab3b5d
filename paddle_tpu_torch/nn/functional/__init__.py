"""paddle.nn.functional subset the ported slice runs (counterpart of
paddle_tpu/nn/functional)."""
from .activation import gelu, tanh  # noqa: F401
from .attention import (flash_attention,  # noqa: F401
                        scaled_dot_product_attention)
from .common import dropout, embedding, linear  # noqa: F401
from .norm import layer_norm  # noqa: F401
