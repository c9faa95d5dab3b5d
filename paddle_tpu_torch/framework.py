"""Tensor, Parameter, the grad modes and to_tensor.

Counterpart of paddle_tpu/framework.py. The JAX package wraps arrays in
its own Tensor and records a tape over jax.vjp; here Tensor IS
torch.Tensor, Parameter IS nn.Parameter, and torch autograd replaces the
tape (the JAX package's TapeNode, backward_from and the tape release are
not ported).

Paddle's Tensor surface reaches torch.Tensor additively, once, at
import (add_methods below; the op methods are added by
ops/__init__.py): a name is set on torch.Tensor only where torch.Tensor
has no attribute of that name, so no method of torch's changes meaning
for torch itself or for the port's own modules. The additions here:
stop_gradient (a property over requires_grad), astype and cast,
clear_gradient and clear_grad, set_value, place, rank and gradient.
`shape` stays torch's torch.Size (a tuple; Paddle returns a list).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .core import dtypes as _dtypes
from .core.place import CPUPlace, CUDAPlace, resolve_device

__all__ = ["Tensor", "Parameter", "no_grad", "enable_grad",
           "is_grad_enabled", "set_grad_enabled", "in_dygraph_mode",
           "to_tensor"]

Tensor = torch.Tensor
Parameter = nn.Parameter
no_grad = torch.no_grad
enable_grad = torch.enable_grad


def is_grad_enabled() -> bool:
    return torch.is_grad_enabled()


class set_grad_enabled:
    """paddle.set_grad_enabled: applies at once, and restores the mode it
    found when used as a context manager (the JAX package's class)."""

    def __init__(self, mode: bool):
        self.prev = torch.is_grad_enabled()
        torch.set_grad_enabled(bool(mode))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        torch.set_grad_enabled(self.prev)


def in_dygraph_mode() -> bool:
    return True  # eager is the default mode, as in paddle 2.x


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


# -- the additive Tensor surface ------------------------------------------------

def _get_stop_gradient(self) -> bool:
    return not self.requires_grad


def _set_stop_gradient(self, value):
    """x.stop_gradient = False makes a leaf collect .grad; = True on a
    tensor inside a graph cuts it from the graph (detach_), as Paddle's
    flag stops the gradient there."""
    value = bool(value)
    if value == (not self.requires_grad):
        return
    if self.is_leaf:
        self.requires_grad_(not value)
    elif value:
        self.detach_()
    else:
        raise RuntimeError(
            "stop_gradient=False on a tensor computed without gradients: "
            "only a leaf can start collecting them")


def _astype(self, dtype):
    return self.to(_dtypes.convert_dtype(dtype))


def _clear_gradient(self, set_to_zero: bool = False):
    if set_to_zero and self.grad is not None:
        self.grad.zero_()
    else:
        self.grad = None


def _clear_grad(self):
    self.grad = None


@torch.no_grad()
def _set_value(self, value):
    """In-place value update outside autograd (an optimizer's write), in
    this tensor's dtype; the shapes must match."""
    v = value if isinstance(value, torch.Tensor) else \
        torch.as_tensor(np.asarray(value))
    if tuple(v.shape) != tuple(self.shape):
        raise ValueError(f"set_value shape mismatch: {tuple(v.shape)} vs "
                         f"{tuple(self.shape)}")
    self.copy_(v)


def _place(self):
    d = self.device
    return CUDAPlace(d.index or 0) if d.type == "cuda" else CPUPlace()


def _rank(self):
    return torch.tensor(self.dim(), dtype=torch.int32, device=self.device)


def _gradient(self):
    """The gradient as a numpy array (None without one)."""
    return None if self.grad is None else self.grad.detach().cpu().numpy()


#: the Paddle names add_methods sets on torch.Tensor at import
TENSOR_SURFACE = {
    "stop_gradient": property(_get_stop_gradient, _set_stop_gradient),
    "astype": _astype,
    "cast": _astype,
    "clear_gradient": _clear_gradient,
    "clear_grad": _clear_grad,
    "set_value": _set_value,
    "place": property(_place),
    "rank": _rank,
    "gradient": _gradient,
}


def add_methods(table) -> list:
    """Set each (name, value) of `table` on torch.Tensor where torch.Tensor
    has no attribute of that name; returns the names set. Nothing torch
    defines is replaced."""
    added = []
    for name, value in table.items():
        if hasattr(torch.Tensor, name):
            continue
        setattr(torch.Tensor, name, value)
        added.append(name)
    return added


#: the names of TENSOR_SURFACE that torch.Tensor lacked (all of them)
SURFACE_ADDED = add_methods(TENSOR_SURFACE)
