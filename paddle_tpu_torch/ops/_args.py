"""Argument normalisation shared by the op modules (the JAX package's
_unwrap, _axis, _norm_shape and _dt)."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes as _dtypes
from ..core.place import resolve_device


def tensor_of(x, like=None) -> torch.Tensor:
    """`x` as a tensor: a tensor passes; a number, list or array goes to
    `like`'s device (else the current one), a Python float in the
    default dtype."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    dev = like.device if isinstance(like, torch.Tensor) else resolve_device()
    if arr.dtype == np.float64 and not isinstance(x, np.ndarray):
        return torch.as_tensor(arr, dtype=_dtypes.get_default_dtype(),
                               device=dev)
    return torch.as_tensor(np.ascontiguousarray(arr), device=dev)


def scalar_of(x):
    """A Python number from a number or a one-element tensor/array."""
    if isinstance(x, torch.Tensor):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.item()
    return x


def axis_of(axis):
    """None, an int, or a tuple of ints (from a list, tuple or tensor)."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def shape_of(shape) -> tuple:
    """A shape as a tuple of ints (from an int, a list of ints or 0-d
    tensors, or a tensor)."""
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(scalar_of(s)) for s in shape)


def dtype_of(dtype, default=None):
    """A torch dtype; None gives `default`, else the default float."""
    if dtype is None:
        return default if default is not None else \
            _dtypes.get_default_dtype()
    return _dtypes.convert_dtype(dtype)
