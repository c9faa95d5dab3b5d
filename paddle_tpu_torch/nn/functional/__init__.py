"""paddle.nn.functional (counterpart of paddle_tpu/nn/functional): each
module's names under the JAX package's __all__."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from . import activation, common, conv, loss, norm, pooling  # noqa: F401
from .attention import (attention_dropout_impl,  # noqa: F401
                        flash_attention, scaled_dot_product_attention)
from .loss import linear_cross_entropy  # noqa: F401
