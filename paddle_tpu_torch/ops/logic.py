"""Comparison and logical ops (counterpart of paddle_tpu/ops/logic.py).

The results are bool tensors (bitwise ops keep the integer dtype);
equal_all, allclose and is_empty give 0-d bool tensors on the input's
device.
"""
from __future__ import annotations

import torch

from ._args import axis_of, tensor_of
from .math import _pair

__all__ = [
    "all", "any",
    "equal", "not_equal", "greater_than", "greater_equal", "less_than",
    "less_equal", "equal_all", "allclose", "isclose", "logical_and",
    "logical_or", "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_not", "bitwise_xor", "is_empty", "is_tensor", "isreal",
    "bitwise_left_shift", "bitwise_right_shift",
]


def _cmp(fn, opname):
    def op(x, y, name=None):
        return fn(*_pair(x, y))
    op.__name__ = opname
    return op


equal = _cmp(torch.eq, "equal")
not_equal = _cmp(torch.ne, "not_equal")
greater_than = _cmp(torch.gt, "greater_than")
greater_equal = _cmp(torch.ge, "greater_equal")
less_than = _cmp(torch.lt, "less_than")
less_equal = _cmp(torch.le, "less_equal")
logical_and = _cmp(torch.logical_and, "logical_and")
logical_or = _cmp(torch.logical_or, "logical_or")
logical_xor = _cmp(torch.logical_xor, "logical_xor")
bitwise_and = _cmp(torch.bitwise_and, "bitwise_and")
bitwise_or = _cmp(torch.bitwise_or, "bitwise_or")
bitwise_xor = _cmp(torch.bitwise_xor, "bitwise_xor")
bitwise_left_shift = _cmp(torch.bitwise_left_shift, "bitwise_left_shift")
bitwise_right_shift = _cmp(torch.bitwise_right_shift,
                           "bitwise_right_shift")


def logical_not(x, name=None):
    return torch.logical_not(tensor_of(x))


def bitwise_not(x, name=None):
    return torch.bitwise_not(tensor_of(x))


def isreal(x, name=None):
    return torch.isreal(tensor_of(x))


def _flag(value, like):
    return torch.tensor(bool(value), device=like.device)


def equal_all(x, y, name=None):
    x = tensor_of(x)
    y = tensor_of(y, like=x)
    if x.shape != y.shape:
        return _flag(False, x)
    return torch.all(x == y)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x = tensor_of(x)
    return _flag(torch.allclose(x, tensor_of(y, like=x), rtol=rtol,
                                atol=atol, equal_nan=equal_nan), x)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x = tensor_of(x)
    return torch.isclose(x, tensor_of(y, like=x), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def is_empty(x, name=None):
    x = tensor_of(x)
    return _flag(x.numel() == 0, x)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def _bool_reduce(fn, x, axis, keepdim):
    x = tensor_of(x)
    ax = axis_of(axis)
    if ax is None:
        out = fn(x)
        return out.reshape((1,) * x.dim()) if keepdim else out
    return fn(x, dim=ax, keepdim=keepdim)


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    """paddle.all (ref reduce_all_op)."""
    return _bool_reduce(torch.all, x, axis, keepdim)


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    """paddle.any (ref reduce_any_op)."""
    return _bool_reduce(torch.any, x, axis, keepdim)
