"""Optimizers and LR schedulers (counterpart of paddle_tpu/optimizer):
the JAX package's ten optimizers, with multi-precision master weights,
lr.py's schedulers, and extras.py's EMA, ModelAverage and Lookahead."""
from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                         AdamW, Lamb, Lars, Momentum, RMSProp)
from .extras import (ExponentialMovingAverage, LookaheadOptimizer,  # noqa: F401
                     ModelAverage)
