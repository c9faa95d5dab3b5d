"""The fleet (counterpart of paddle_tpu/distributed/fleet): the
strategy and its compiler (base.py, meta_optimizers.py), the global
metrics (metrics/) and the utilities (utils/: fs, the KV store and
heartbeats)."""
from .base import (DistributedStrategy, PaddleCloudRoleMaker,  # noqa: F401
                   UserDefinedRoleMaker, fleet, init, is_first_worker,
                   worker_index, worker_num, distributed_optimizer,
                   distributed_model, DistributedOptimizer)
from . import meta_optimizers  # noqa: F401
from .meta_optimizers import (StrategyCompiler, TrainStepSpec,  # noqa: F401
                              LocalSGDStep, META_OPTIMIZERS)
from . import metrics  # noqa: F401
from . import utils  # noqa: F401
