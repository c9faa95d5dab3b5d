"""Normalization layers (counterpart of paddle_tpu/nn/layer/norm.py)."""
from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = ["LayerNorm"]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, device=None, dtype="float32"):
        super().__init__(dtype=dtype, device=device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter(self.normalized_shape, attr=weight_attr,
                                  default_initializer=Constant(1.0))
        self.bias = self.create_parameter(
            self.normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight,
                            self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}"
