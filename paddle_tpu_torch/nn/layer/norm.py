"""Normalization layers (counterpart of paddle_tpu/nn/layer/norm.py).

BatchNorm keeps its running statistics as buffers named `_mean` and
`_variance` (the JAX package's state-dict names), zeros and ones at the
start, written in place by F.batch_norm in training (see
nn/functional/norm.py for the update, and static/train_step.py for how
a step carries them).

SyncBatchNorm averages the batch mean and the mean square deviation
over the data ranks: the groups of the current batch_stat_scope (set by
DataParallel and by TrainStep over a mesh), else the dp axis's group
(distributed/env.py axis_group: the axis context's, or the mesh's, or
the world's), through the helper plain BatchNorm uses under a
batch_stat_scope. With no process group it is plain BatchNorm, as the
JAX docstring says of it outside a sharded region.
"""
from __future__ import annotations

import torch

from .. import functional as F
from ..functional import norm as _norm
from ..initializer import Constant, Normal
from .layers import Layer

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None,
                 dtype="float32"):
        super().__init__(dtype=dtype, device=device)
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        self.weight = None if weight_attr is False else \
            self.create_parameter((num_features,), attr=weight_attr,
                                  default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_features,), attr=bias_attr, is_bias=True)
        self.register_buffer("_mean", torch.zeros(
            (num_features,), dtype=torch.float32, device=self._device))
        self.register_buffer("_variance", torch.ones(
            (num_features,), dtype=torch.float32, device=self._device))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self.momentum,
            epsilon=self.epsilon, data_format=self.data_format,
            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}"


class BatchNorm(_BatchNormBase):
    """fluid-style BatchNorm (act="relu" applies a ReLU after)."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 in_place=False, use_global_stats=False,
                 trainable_statistics=False, device=None, dtype="float32",
                 **kwargs):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats or None,
                         device=device, dtype=dtype)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act == "relu":
            return F.relu(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None, device=None,
                 dtype="float32"):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device, dtype=dtype)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None, device=None,
                 dtype="float32"):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats,
                         device=device, dtype=dtype)


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica batch norm: the batch moments averaged over the data
    ranks in training (module docstring); plain BatchNorm in eval and
    without a process group."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype="float32"):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, device=device, dtype=dtype)

    def _groups(self):
        groups = _norm.stat_groups()
        if groups:
            return groups
        from ...distributed.env import (DATA_AXIS, axis_group,
                                        current_axis_name)
        pg = axis_group(current_axis_name(DATA_AXIS) or DATA_AXIS)
        return [pg] if pg is not None else None

    def forward(self, x):
        groups = self._groups() if self.training else None
        if not groups:
            return super().forward(x)
        with _norm.batch_stat_scope(groups):
            return super().forward(x)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Each BatchNorm* sublayer (and `layer` itself) swapped for a
        SyncBatchNorm with its weights and running statistics."""
        if isinstance(layer, _BatchNormBase) and not isinstance(
                layer, SyncBatchNorm):
            new = cls(layer.num_features, layer.momentum, layer.epsilon,
                      weight_attr=False if layer.weight is None else None,
                      bias_attr=False if layer.bias is None else None,
                      data_format=layer.data_format, device=layer._device)
            with torch.no_grad():
                for name in ("weight", "bias", "_mean", "_variance"):
                    src = getattr(layer, name)
                    if src is not None:
                        getattr(new, name).copy_(src)
            return new
        for name, sub in list(layer._modules.items()):
            if sub is not None:
                layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return layer


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


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype="float32"):
        super().__init__(dtype=dtype, device=device)
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.epsilon = epsilon
        self.data_format = data_format
        self.weight = None if weight_attr is False else \
            self.create_parameter((num_channels,), attr=weight_attr,
                                  default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            (num_channels,), attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self.num_groups, self.epsilon, self.weight,
                            self.bias, self.data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, device=None, dtype="float32"):
        super().__init__(dtype=dtype, device=device)
        self.num_features = num_features
        self.epsilon = epsilon
        self.data_format = data_format
        if weight_attr is False or bias_attr is False:
            self.weight = None
            self.bias = None
        else:
            self.weight = self.create_parameter(
                (num_features,), attr=weight_attr,
                default_initializer=Constant(1.0))
            self.bias = self.create_parameter(
                (num_features,), attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self.epsilon,
                               data_format=self.data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=0.0001, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size = size
        self.alpha = alpha
        self.beta = beta
        self.k = k
        self.data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """weight / sigma, sigma from `power_iters` power iterations from the
    vectors weight_u and weight_v (parameters that take no gradient and
    are not written back, as in the JAX package)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32", device=None):
        super().__init__(dtype=dtype, device=device)
        self.dim = dim
        self.power_iters = power_iters
        self.eps = eps
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        self.weight_u = self.create_parameter(
            (h,), default_initializer=Normal(0, 1))
        self.weight_v = self.create_parameter(
            (w,), default_initializer=Normal(0, 1))
        self.weight_u.requires_grad_(False)
        self.weight_v.requires_grad_(False)

    def forward(self, weight):
        wm = weight.movedim(self.dim, 0).reshape(weight.shape[self.dim], -1)
        u, v = self.weight_u, self.weight_v
        for _ in range(self.power_iters):
            v = wm.t() @ u
            v = v / (torch.linalg.norm(v) + self.eps)
            u = wm @ v
            u = u / (torch.linalg.norm(u) + self.eps)
        sigma = u @ wm @ v
        return weight / sigma
