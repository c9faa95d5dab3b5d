"""Activation functionals (counterpart of
paddle_tpu/nn/functional/activation.py).

Each is the JAX function's formula in torch ops; softmax and log_softmax
are AMP black-list ops ("softmax_op", "log_softmax_op"), float32 under
auto_cast, as in the JAX package. The in-place variants (relu_, elu_,
softmax_, tanh_) write into x through torch's in-place ops (autograd
refuses them on a leaf that requires grad, as the JAX package does).
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import amp_cast

__all__ = [
    "relu_", "elu_", "softmax_",
    "relu", "relu6", "elu", "selu", "celu", "gelu", "sigmoid", "hardsigmoid",
    "hardswish", "hardtanh", "hardshrink", "softshrink", "tanhshrink",
    "leaky_relu", "prelu", "rrelu", "log_sigmoid", "log_softmax", "softmax",
    "softplus", "softsign", "swish", "silu", "mish", "maxout",
    "thresholded_relu", "glu", "gumbel_softmax", "tanh_", "tanh",
]


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return TF.relu6(x)


def elu(x, alpha=1.0, name=None):
    return TF.elu(x, alpha=alpha)


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    return TF.celu(x, alpha=alpha)


def gelu(x, approximate=False, name=None):
    """Exact erf GELU unless approximate=True (tanh form), as jax.nn.gelu
    is called by the JAX package."""
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def tanh(x, name=None):
    return torch.tanh(x)


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, torch.zeros_like(x))


def softshrink(x, threshold=0.5, name=None):
    zero = torch.zeros_like(x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, zero))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return TF.leaky_relu(x, negative_slope)


def prelu(x, weight, data_format="NCHW", name=None):
    w = weight
    if w.dim() == 1 and w.shape[0] != 1 and x.dim() > 1:
        # per-channel: broadcast across the spatial dims
        ch_axis = 1 if data_format[1] == "C" else x.dim() - 1
        shape = [1] * x.dim()
        shape[ch_axis] = w.shape[0]
        w = w.reshape(shape)
    return torch.where(x >= 0, x, w * x)


def rrelu(x, lower=0.125, upper=0.3333333, training=True, name=None):
    """The JAX package's rrelu: the mean slope, in training too."""
    slope = (lower + upper) / 2.0
    return torch.where(x >= 0, x, slope * x)


def log_sigmoid(x, name=None):
    return TF.logsigmoid(x)


def softmax(x, axis=-1, dtype=None, name=None):
    """An AMP black-list op ("softmax_op"): float32 under auto_cast."""
    (x,) = amp_cast("softmax_op", x)
    return torch.softmax(x, dim=axis, dtype=dtype)


def log_softmax(x, axis=-1, dtype=None, name=None):
    (x,) = amp_cast("log_softmax_op", x)
    return torch.log_softmax(x, dim=axis, dtype=dtype)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """Black-list op ("softplus"). x where beta*x > threshold, else
    log(1 + exp(beta*x)) / beta, as the JAX package's logaddexp form."""
    (x,) = amp_cast("softplus", x)
    scaled = beta * x
    return torch.where(scaled > threshold, x,
                       torch.logaddexp(scaled, torch.zeros_like(x)) / beta)


def softsign(x, name=None):
    return TF.softsign(x)


def swish(x, name=None):
    return TF.silu(x)


silu = swish


def mish(x, name=None):
    return x * torch.tanh(TF.softplus(x))


def maxout(x, groups, axis=1, name=None):
    nd = x.dim()
    axis = axis % nd
    c = x.shape[axis]
    new_shape = x.shape[:axis] + (c // groups, groups) + x.shape[axis + 1:]
    return x.reshape(new_shape).amax(dim=axis + 1)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, torch.full_like(x, value))


def glu(x, axis=-1, name=None):
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, generator=None,
                   name=None):
    """Softmax of (x + Gumbel noise) / temperature; hard=True returns the
    one-hot argmax with the soft gradient (straight-through). The noise
    comes from `generator` (the JAX package's `key`), by default the
    device's."""
    from ...core.generator import default_generator
    g = generator if generator is not None else default_generator(x.device)
    u = torch.empty_like(x).uniform_(generator=g)
    tiny = torch.finfo(u.dtype).tiny
    noise = -torch.log((-torch.log(u.clamp_min(tiny))).clamp_min(tiny))
    y = torch.softmax((x + noise) / temperature, dim=axis)
    if hard:
        idx = y.argmax(dim=axis, keepdim=True)
        hard_y = torch.zeros_like(y).scatter_(axis, idx, 1.0)
        y = (hard_y - y).detach() + y
    return y


def relu_(x, name=None):
    return x.relu_()


def elu_(x, alpha=1.0, name=None):
    return TF.elu_(x, alpha)


def softmax_(x, axis=-1, dtype=None, name=None):
    return x.copy_(softmax(x, axis, dtype))


def tanh_(x, name=None):
    return x.tanh_()
