"""Activation layers (counterpart of paddle_tpu/nn/layer/activation.py).
Each holds its arguments and calls its functional; PReLU alone has a
parameter."""
from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from .layers import Layer

__all__ = [
    "ReLU", "ReLU6", "ELU", "SELU", "CELU", "GELU", "Sigmoid", "Hardsigmoid",
    "Hardswish", "Hardtanh", "Hardshrink", "Softshrink", "Tanhshrink",
    "LeakyReLU", "PReLU", "RReLU", "LogSigmoid", "LogSoftmax", "Softmax",
    "Softplus", "Softsign", "Swish", "Silu", "Mish", "Maxout",
    "ThresholdedReLU", "GLU", "Tanh",
]


def _simple(name, fn_name, **defaults):
    def __init__(self, name=None, device=None, **kwargs):
        Layer.__init__(self, device=device)
        self._kwargs = {**defaults, **kwargs}

    def forward(self, x):
        return getattr(F, fn_name)(x, **self._kwargs)

    return type(name, (Layer,), {"__init__": __init__, "forward": forward,
                                 "__module__": __name__})


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Sigmoid = _simple("Sigmoid", "sigmoid")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
Softsign = _simple("Softsign", "softsign")
Swish = _simple("Swish", "swish")
Silu = _simple("Silu", "silu")
Mish = _simple("Mish", "mish")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
Hardswish = _simple("Hardswish", "hardswish")
Tanh = _simple("Tanh", "tanh")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")


class ELU(Layer):
    def __init__(self, alpha=1.0, name=None, device=None):
        super().__init__(device=device)
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class SELU(Layer):
    def __init__(self, scale=1.0507009873554805, alpha=1.6732632423543772,
                 name=None, device=None):
        super().__init__(device=device)
        self.scale, self.alpha = scale, alpha

    def forward(self, x):
        return F.selu(x, self.scale, self.alpha)


class CELU(Layer):
    def __init__(self, alpha=1.0, name=None, device=None):
        super().__init__(device=device)
        self.alpha = alpha

    def forward(self, x):
        return F.celu(x, self.alpha)


class GELU(Layer):
    def __init__(self, approximate=False, name=None, device=None):
        super().__init__(device=device)
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, self.approximate)


class Hardtanh(Layer):
    def __init__(self, min=-1.0, max=1.0, name=None, device=None):
        super().__init__(device=device)
        self.min, self.max = min, max

    def forward(self, x):
        return F.hardtanh(x, self.min, self.max)


class Hardshrink(Layer):
    def __init__(self, threshold=0.5, name=None, device=None):
        super().__init__(device=device)
        self.threshold = threshold

    def forward(self, x):
        return F.hardshrink(x, self.threshold)


class Softshrink(Layer):
    def __init__(self, threshold=0.5, name=None, device=None):
        super().__init__(device=device)
        self.threshold = threshold

    def forward(self, x):
        return F.softshrink(x, self.threshold)


class LeakyReLU(Layer):
    def __init__(self, negative_slope=0.01, name=None, device=None):
        super().__init__(device=device)
        self.negative_slope = negative_slope

    def forward(self, x):
        return F.leaky_relu(x, self.negative_slope)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, device=None,
                 dtype="float32"):
        super().__init__(dtype=dtype, device=device)
        self.data_format = data_format
        self.weight = self.create_parameter(
            (num_parameters,), attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self.data_format)


class RReLU(Layer):
    def __init__(self, lower=0.125, upper=0.3333333, name=None, device=None):
        super().__init__(device=device)
        self.lower, self.upper = lower, upper

    def forward(self, x):
        return F.rrelu(x, self.lower, self.upper, training=self.training)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None, device=None):
        super().__init__(device=device)
        self.axis = axis

    def forward(self, x):
        return F.softmax(x, self.axis)


class LogSoftmax(Layer):
    def __init__(self, axis=-1, name=None, device=None):
        super().__init__(device=device)
        self.axis = axis

    def forward(self, x):
        return F.log_softmax(x, self.axis)


class Softplus(Layer):
    def __init__(self, beta=1.0, threshold=20.0, name=None, device=None):
        super().__init__(device=device)
        self.beta, self.threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self.beta, self.threshold)


class Maxout(Layer):
    def __init__(self, groups, axis=1, name=None, device=None):
        super().__init__(device=device)
        self.groups, self.axis = groups, axis

    def forward(self, x):
        return F.maxout(x, self.groups, self.axis)


class ThresholdedReLU(Layer):
    def __init__(self, threshold=1.0, value=0.0, name=None, device=None):
        super().__init__(device=device)
        self.threshold, self.value = threshold, value

    def forward(self, x):
        return F.thresholded_relu(x, self.threshold, self.value)


class GLU(Layer):
    def __init__(self, axis=-1, name=None, device=None):
        super().__init__(device=device)
        self.axis = axis

    def forward(self, x):
        return F.glu(x, self.axis)
