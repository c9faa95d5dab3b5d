"""paddle.nn (counterpart of paddle_tpu/nn): layers, functionals,
initializers, clips, the beam-search decoder and the weight
reparameterisations."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from . import extension  # noqa: F401
from . import vision  # noqa: F401
from . import weight_norm_hook  # noqa: F401
from . import clip  # noqa: F401
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa: F401
from .layer import *  # noqa: F401,F403
from .layer import Layer, ScannedStack  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401
from .utils import weight_norm, remove_weight_norm, spectral_norm  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
