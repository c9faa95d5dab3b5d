"""Distributed (counterpart of paddle_tpu/distributed): activation
recomputation, and the elastic plane: checkpoints (checkpoint.py), the
supervisor's state machine (elastic.py), chaos hooks (chaos.py), the
fleet KV and heartbeats (fleet/utils), the launcher (launch.py) and its
drill worker (elastic_worker.py). Collectives, data parallel, sharding
and the parallel forms come with ROADMAP.md items 13-14."""
from . import chaos, checkpoint, elastic  # noqa: F401
from .recompute import (RecomputeFunction, recompute,  # noqa: F401
                        recompute_sequential)
