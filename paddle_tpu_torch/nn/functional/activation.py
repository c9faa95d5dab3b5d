"""Activations ERNIE uses (counterpart of
paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast

__all__ = ["gelu", "tanh", "softmax"]


def gelu(x, approximate=False, name=None):
    """Exact erf GELU unless approximate=True (tanh form), as jax.nn.gelu
    is called by the JAX package."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    return torch.tanh(x)


def softmax(x, axis=-1, dtype=None, name=None):
    """An AMP black-list op ("softmax_op"): float32 under auto_cast."""
    (x,) = amp_cast("softmax_op", x)
    return torch.softmax(x, dim=axis, dtype=dtype)
