"""Statistics ops (counterpart of paddle_tpu/ops/stat.py)."""
from __future__ import annotations

import torch

from ._args import axis_of, tensor_of

__all__ = ["std", "var", "numel_stat"]


def _moment(fn, x, axis, unbiased, keepdim):
    x = tensor_of(x)
    return fn(x, dim=axis_of(axis), correction=1 if unbiased else 0,
              keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moment(torch.std, x, axis, unbiased, keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _moment(torch.var, x, axis, unbiased, keepdim)


def numel_stat(x):
    from .creation import numel
    return numel(x)
