"""paddle.incubate.optimizer (reference
python/paddle/incubate/optimizer/__init__.py: LookAhead, ModelAverage).
The implementations live in optimizer/extras.py; LookAhead is the
2.0-facing name of the Lookahead wrapper."""
from ..optimizer.extras import LookaheadOptimizer as LookAhead  # noqa: F401
from ..optimizer.extras import ModelAverage  # noqa: F401

__all__ = ["LookAhead", "ModelAverage"]
