"""Training step (counterpart of paddle_tpu/static: TrainStep only)."""
from .train_step import TrainStep  # noqa: F401
