"""Optimizers and LR schedulers (counterpart of paddle_tpu/optimizer):
Adam and AdamW with multi-precision master weights; the other
optimizers come with a later slice."""
from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import Adam, AdamW  # noqa: F401
