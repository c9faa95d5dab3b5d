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

# math-namespace ops that paddle also exposes under F.*
from ...ops.math import abs, square, sqrt  # noqa: F401,E402

# vision sampling + unpool live with the op batch (ops/extras.py)
from ...ops.extras import (affine_grid, grid_sample,  # noqa: F401,E402
                           max_unpool2d)

from . import extension  # noqa: F401,E402
from .extension import diag_embed, gather_tree  # noqa: F401,E402
