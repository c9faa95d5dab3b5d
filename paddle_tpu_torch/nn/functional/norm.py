"""layer_norm (counterpart of paddle_tpu/nn/functional/norm.py)."""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon=1e-05, name=None):
    """(x - mean) / sqrt(var + eps) * weight + bias over the trailing
    `normalized_shape` dims, with the biased variance, as the JAX
    package computes it. An AMP black-list op ("layer_norm_op"): float32
    in and out under auto_cast."""
    if normalized_shape is None:
        normalized_shape = (x.shape[-1],)
    elif isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = amp_cast("layer_norm_op", x, weight, bias)
    return torch.nn.functional.layer_norm(
        x, tuple(normalized_shape), weight, bias, epsilon)
