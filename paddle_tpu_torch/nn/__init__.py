"""paddle.nn subset the ported slices run (counterpart of
paddle_tpu/nn): layers, functionals, initializers, clips."""
from . import clip, functional, initializer  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .layer import *  # noqa: F401,F403
from .layer import Layer, ScannedStack  # noqa: F401
