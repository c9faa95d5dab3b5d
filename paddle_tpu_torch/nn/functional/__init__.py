"""paddle.nn.functional subset the ported slices run (counterpart of
paddle_tpu/nn/functional)."""
from .activation import gelu, softmax, tanh  # noqa: F401
from .attention import (attention_dropout_impl,  # noqa: F401
                        flash_attention, scaled_dot_product_attention)
from .common import dropout, embedding, linear  # noqa: F401
from .loss import (cross_entropy, linear_cross_entropy,  # noqa: F401
                   softmax_with_cross_entropy)
from .norm import layer_norm  # noqa: F401
