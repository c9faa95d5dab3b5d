"""Weight initializers (counterpart of paddle_tpu/nn/initializer.py).

Each initializer is a callable (shape, dtype, device, generator) -> tensor.
It draws from the explicit generator it is given, by default the
device's default generator, so paddle_tpu_torch.seed() makes
initialization deterministic. Draws are made in float32 and cast, so a
bf16 parameter holds the rounded f32 draw. The distributions are the JAX
package's; the numbers differ for the same seed (tests carry weights
across by name).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dtypes as _dtypes
from ..core.generator import default_generator

__all__ = [
    "Bilinear", "set_global_initializer",
    "Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
    "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
    "Assign", "Orthogonal", "Dirac", "calculate_gain",
]


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


def calculate_gain(nonlinearity, param=None):
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(2.0 / (1 + (param if param is not None
                                            else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unknown nonlinearity '{nonlinearity}'")
    return gains[nonlinearity]


class Initializer:
    def __call__(self, shape, dtype, device, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, shape, dtype, device, generator=None):
        return torch.full(tuple(shape), float(self.value),
                          dtype=_dtypes.convert_dtype(dtype), device=device)


def _draw(shape, dtype, device, generator, fill):
    """fill(tensor, generator) on a float32 tensor of `shape`, cast to
    `dtype`; the generator defaults to the device's."""
    g = generator if generator is not None else default_generator(device)
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    fill(out, g)
    return out.to(_dtypes.convert_dtype(dtype))


def _normal(shape, mean, std, dtype, device, generator):
    return _draw(shape, dtype, device, generator,
                 lambda t, g: t.normal_(mean, std, generator=g))


def _uniform(shape, low, high, dtype, device, generator):
    return _draw(shape, dtype, device, generator,
                 lambda t, g: t.uniform_(low, high, generator=g))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device, generator=None):
        return _normal(shape, self.mean, self.std, dtype, device, generator)


class TruncatedNormal(Initializer):
    """A standard normal truncated to [-2, 2], times std, plus mean (the
    JAX package's jax.random.truncated_normal(-2, 2))."""

    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, device, generator=None):
        def fill(t, g):
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
            t.mul_(self.std).add_(self.mean)
        return _draw(shape, dtype, device, generator, fill)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, device, generator=None):
        return _uniform(shape, self.low, self.high, dtype, device, generator)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device, generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return _normal(shape, 0.0, std, dtype, device, generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, device, generator=None):
        fi, fo = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return _uniform(shape, -limit, limit, dtype, device, generator)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device, generator=None):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        return _normal(shape, 0.0, gain / math.sqrt(fi), dtype, device,
                       generator)


class KaimingUniform(Initializer):
    """Conv's default (nn/layer/conv.py): U(-limit, limit), limit = gain
    * sqrt(3 / fan_in)."""

    def __init__(self, fan_in=None, negative_slope=0.0,
                 nonlinearity="relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, device, generator=None):
        fi, _ = _fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        gain = calculate_gain(self.nonlinearity, self.negative_slope)
        limit = gain * math.sqrt(3.0 / fi)
        return _uniform(shape, -limit, limit, dtype, device, generator)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype, device, generator=None):
        v = self.value
        t = v.detach() if isinstance(v, torch.Tensor) else \
            torch.as_tensor(np.asarray(v))
        t = t.to(device=device, dtype=_dtypes.convert_dtype(dtype))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"Assign shape {tuple(t.shape)} != param shape "
                             f"{tuple(shape)}")
        return t.clone()


def _orthogonal(shape, gain, device, generator):
    """jax.nn.initializers.orthogonal (column_axis -1): an orthogonal
    [prod(shape[:-1]), shape[-1]] matrix reshaped to `shape`, times gain
    (torch's orthogonal_ alone would flatten dims 1: instead)."""
    rows = int(math.prod(shape[:-1]))
    g = generator if generator is not None else default_generator(device)
    m = torch.empty((rows, shape[-1]), dtype=torch.float32, device=device)
    torch.nn.init.orthogonal_(m, gain, generator=g)
    return m.reshape(tuple(shape))


class Orthogonal(Initializer):
    def __init__(self, gain=1.0):
        self.gain = gain

    def __call__(self, shape, dtype, device, generator=None):
        if len(shape) < 2:
            raise ValueError("orthogonal initializer requires at least a 2D "
                             "shape")
        return _orthogonal(tuple(shape), self.gain, device, generator).to(
            _dtypes.convert_dtype(dtype))


class Dirac(Initializer):
    """The JAX package's Dirac: jax.nn.initializers.delta_orthogonal on
    the shape as given (groups is not read). delta_orthogonal takes the
    LAST two dims as (in, out) and the leading ones as the window, so on
    a paddle kernel [out_c, in_c, k, k] it writes one orthogonal k x k
    matrix at [(out_c - 1) // 2, (in_c - 1) // 2] and zeros elsewhere.
    The port keeps that (ROADMAP.md queue C notes)."""

    def __init__(self, groups=1):
        self.groups = groups

    def __call__(self, shape, dtype, device, generator=None):
        shape = tuple(shape)
        if len(shape) not in (3, 4, 5):
            raise ValueError("Delta orthogonal initializer requires a 3D, "
                             "4D or 5D shape.")
        if shape[-1] < shape[-2]:
            raise ValueError("`fan_in` must be less or equal than "
                             "`fan_out`. ")
        w = torch.zeros(shape, dtype=torch.float32, device=device)
        centre = tuple((k - 1) // 2 for k in shape[:-2])
        w[centre] = _orthogonal(shape[-2:], 1.0, device, generator)
        return w.to(_dtypes.convert_dtype(dtype))


class Bilinear(Initializer):
    """Bilinear-upsampling kernel for a transposed conv [c_out, c_in, kh,
    kw]: the same filter on each diagonal channel pair, zeros elsewhere."""

    def __call__(self, shape, dtype="float32", device=None, generator=None):
        if len(shape) != 4:
            raise ValueError("Bilinear expects a conv kernel shape "
                             "[c_out, c_in, kh, kw]")
        c_out, c_in, kh, kw = shape
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        ch = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        cw = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        og = np.ogrid[:kh, :kw]
        filt = ((1 - abs(og[0] / f_h - ch))
                * (1 - abs(og[1] / f_w - cw))).astype(np.float32)
        w = np.zeros(tuple(shape), np.float32)
        for i in range(min(c_out, c_in)):
            w[i, i] = filt
        return torch.from_numpy(w).to(device=device,
                                      dtype=_dtypes.convert_dtype(dtype))


BilinearInitializer = Bilinear

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None):
    """The defaults Layer.create_parameter falls back to when no
    initializer is given (an explicit one still wins). Pass None to
    restore the built-in defaults."""
    global _global_weight_init, _global_bias_init
    _global_weight_init = weight_init
    _global_bias_init = bias_init


def _global_default(is_bias):
    return _global_bias_init if is_bias else _global_weight_init
