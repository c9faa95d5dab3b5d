"""Weight initializers (counterpart of paddle_tpu/nn/initializer.py).

Each initializer is a callable (shape, dtype, device, generator) -> tensor.
It draws from the explicit generator it is given, by default the
device's default generator, so paddle_tpu_torch.seed() makes
initialization deterministic. Draws are made in float32 and cast, so a
bf16 parameter holds the rounded f32 draw.
"""
from __future__ import annotations

import math

import torch

from ..core import dtypes as _dtypes
from ..core.generator import default_generator

__all__ = ["Initializer", "Constant", "Normal", "XavierNormal"]


def _fans(shape):
    """(fan_in, fan_out) as the JAX package computes them: a scalar's
    (1, 1), a vector's (n, n), an [in, out] matrix's; for more dims
    (conv kernels [out_c, in_c, *spatial], and MoE's stacked experts)
    in = shape[1] * receptive, out = shape[0] * receptive."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(math.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    def __call__(self, shape, dtype, device, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device, generator=None):
        return torch.full(tuple(shape), float(self.value),
                          dtype=_dtypes.convert_dtype(dtype), device=device)


def _normal(shape, mean, std, dtype, device, generator):
    g = generator if generator is not None else default_generator(device)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    out.normal_(mean, std, generator=g)
    return out.to(_dtypes.convert_dtype(dtype))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device, generator=None):
        return _normal(shape, self.mean, self.std, dtype, device, generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device, generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _normal(shape, 0.0, std, dtype, device, generator)
