"""paddle.incubate: incubating APIs (counterpart of paddle_tpu/incubate,
reference python/paddle/incubate/__init__.py): the optimizer extras and
the contrib reader namespace."""
from . import optimizer  # noqa: F401
from .optimizer import LookAhead, ModelAverage  # noqa: F401
from ..io import dataloader as reader  # noqa: F401

__all__ = ["reader", "optimizer"] + optimizer.__all__
