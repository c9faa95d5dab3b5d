"""Activations ERNIE uses (counterpart of
paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch

__all__ = ["gelu", "tanh"]


def gelu(x, approximate=False, name=None):
    """Exact erf GELU unless approximate=True (tanh form), as jax.nn.gelu
    is called by the JAX package."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    return torch.tanh(x)
