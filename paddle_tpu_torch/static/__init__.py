"""Training step (counterpart of paddle_tpu/static: TrainStep, and
InputSpec re-exported from jit as the JAX package's static does)."""
from ..jit.api import InputSpec  # noqa: F401
from .train_step import TrainStep  # noqa: F401
