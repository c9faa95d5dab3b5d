"""Tensor, Parameter, no_grad and to_tensor.

Counterpart of paddle_tpu/framework.py. The JAX package wraps arrays in
its own Tensor and records a tape over jax.vjp; here Tensor IS
torch.Tensor, Parameter IS nn.Parameter, and torch autograd replaces the
tape.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .core import dtypes as _dtypes
from .core.place import resolve_device

__all__ = ["Tensor", "Parameter", "no_grad", "to_tensor"]

Tensor = torch.Tensor
Parameter = nn.Parameter
no_grad = torch.no_grad


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """paddle.to_tensor: copy `data` onto `place` (default: the current
    device). Python floats take the default dtype, as in Paddle."""
    if isinstance(data, torch.Tensor):
        t = data.detach()
    else:
        arr = np.asarray(data)
        if (dtype is None and arr.dtype == np.float64
                and not isinstance(data, np.ndarray)):
            dtype = _dtypes.get_default_dtype()
        t = torch.from_numpy(np.ascontiguousarray(arr))
    t = t.to(device=resolve_device(place),
             dtype=_dtypes.convert_dtype(dtype) if dtype else None)
    if not stop_gradient:
        t.requires_grad_(True)
    return t
