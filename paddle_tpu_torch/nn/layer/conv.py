"""Conv layers (counterpart of paddle_tpu/nn/layer/conv.py).

Weights keep paddle's layouts: (out, in/groups, *k), and for the
transposes (in, out/groups, *k); KaimingUniform over fan_in = in/groups
* prod(k) unless an initializer is given, biases zeros.
"""
from __future__ import annotations

import numpy as np

from .. import functional as F
from ..initializer import KaimingUniform
from .layers import Layer

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


def _ntuple(v, n):
    return (int(v),) * n if isinstance(v, (int, np.integer)) \
        else tuple(int(i) for i in v)


class _ConvNd(Layer):
    ndim = 2
    transpose = False

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 padding_mode="zeros", weight_attr=None, bias_attr=None,
                 data_format=None, name=None, device=None, dtype="float32"):
        super().__init__(dtype=dtype, device=device)
        n = self.ndim
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, n)
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.dilation = dilation
        self.groups = groups
        self.padding_mode = padding_mode
        self.data_format = data_format
        if self.transpose:
            wshape = (in_channels, out_channels // groups) + self.kernel_size
        else:
            wshape = (out_channels, in_channels // groups) + self.kernel_size
        fan_in = (in_channels // groups) * int(np.prod(self.kernel_size))
        self.weight = self.create_parameter(
            wshape, attr=weight_attr,
            default_initializer=KaimingUniform(fan_in=fan_in))
        self.bias = self.create_parameter(
            (out_channels,), attr=bias_attr, is_bias=True)

    def extra_repr(self):
        return (f"{self.in_channels}, {self.out_channels}, "
                f"kernel_size={self.kernel_size}, stride={self.stride}")


class Conv1D(_ConvNd):
    ndim = 1

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups,
                        self.data_format or "NCL")


class Conv2D(_ConvNd):
    ndim = 2

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups,
                        self.data_format or "NCHW")


class Conv3D(_ConvNd):
    ndim = 3

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                        self.dilation, self.groups,
                        self.data_format or "NCDHW")


class Conv1DTranspose(_ConvNd):
    ndim = 1
    transpose = True

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(
            x, self.weight, self.bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation, output_size,
            self.data_format or "NCL")


class Conv2DTranspose(_ConvNd):
    ndim = 2
    transpose = True

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(
            x, self.weight, self.bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation, output_size,
            self.data_format or "NCHW")


class Conv3DTranspose(_ConvNd):
    ndim = 3
    transpose = True

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(
            x, self.weight, self.bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation, output_size,
            self.data_format or "NCDHW")
