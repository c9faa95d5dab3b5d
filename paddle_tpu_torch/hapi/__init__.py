"""paddle.hapi (counterpart of paddle_tpu/hapi): Model (prepare, fit,
evaluate, predict, save, load, summary) over static.TrainStep, the
training callbacks and summary."""
from .callbacks import (Callback, EarlyStopping, LRScheduler as  # noqa: F401
                        LRSchedulerCallback, MetricsLogger, ModelCheckpoint,
                        ProgBarLogger)
from .model import Model  # noqa: F401
from .summary import summary  # noqa: F401
