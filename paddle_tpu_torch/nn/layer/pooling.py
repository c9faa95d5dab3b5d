"""Pooling layers (counterpart of paddle_tpu/nn/layer/pooling.py)."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = [
    "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
    "MaxPool3D", "AdaptiveAvgPool1D", "AdaptiveAvgPool2D",
    "AdaptiveAvgPool3D", "AdaptiveMaxPool1D", "AdaptiveMaxPool2D",
    "AdaptiveMaxPool3D",
]


class _PoolNd(Layer):
    default_format = "NCHW"

    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, return_mask=False,
                 data_format=None, name=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.ceil_mode = ceil_mode
        self.exclusive = exclusive
        self.divisor_override = divisor_override
        self.return_mask = return_mask
        self.data_format = data_format or self.default_format


class MaxPool1D(_PoolNd):
    default_format = "NCL"

    def forward(self, x):
        return F.max_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.return_mask,
                            self.data_format)


class MaxPool2D(_PoolNd):
    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.return_mask,
                            self.data_format)


class MaxPool3D(_PoolNd):
    default_format = "NCDHW"

    def forward(self, x):
        return F.max_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.return_mask,
                            self.data_format)


class AvgPool1D(_PoolNd):
    default_format = "NCL"

    def forward(self, x):
        return F.avg_pool1d(x, self.kernel_size, self.stride, self.padding,
                            self.exclusive, self.ceil_mode, self.data_format)


class AvgPool2D(_PoolNd):
    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override, self.data_format)


class AvgPool3D(_PoolNd):
    default_format = "NCDHW"

    def forward(self, x):
        return F.avg_pool3d(x, self.kernel_size, self.stride, self.padding,
                            self.ceil_mode, self.exclusive,
                            self.divisor_override, self.data_format)


class _AdaptivePoolNd(Layer):
    def __init__(self, output_size, return_mask=False, data_format=None,
                 name=None):
        super().__init__()
        self.output_size = output_size
        self.return_mask = return_mask
        self.data_format = data_format


class AdaptiveAvgPool1D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size,
                                     self.data_format or "NCHW")


class AdaptiveAvgPool3D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size,
                                     self.data_format or "NCDHW")


class AdaptiveMaxPool1D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_max_pool1d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool2D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size, self.return_mask)


class AdaptiveMaxPool3D(_AdaptivePoolNd):
    def forward(self, x):
        return F.adaptive_max_pool3d(x, self.output_size, self.return_mask)
