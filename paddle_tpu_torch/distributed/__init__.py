"""Distributed (counterpart of paddle_tpu/distributed): only activation
recomputation so far; collectives, data parallel, sharding and the
parallel forms come with the distributed slice (ROADMAP.md items 13-15)."""
from .recompute import (RecomputeFunction, recompute,  # noqa: F401
                        recompute_sequential)
