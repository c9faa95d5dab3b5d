"""layer_norm (counterpart of paddle_tpu/nn/functional/norm.py)."""
from __future__ import annotations

import torch

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon=1e-05, name=None):
    """(x - mean) / sqrt(var + eps) * weight + bias over the trailing
    `normalized_shape` dims, with the biased variance, as the JAX
    package computes it."""
    if normalized_shape is None:
        normalized_shape = (x.shape[-1],)
    elif isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return torch.nn.functional.layer_norm(
        x, tuple(normalized_shape), weight, bias, epsilon)
