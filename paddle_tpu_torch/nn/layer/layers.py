"""Layer: the module base class.

Counterpart of paddle_tpu/nn/layer/layers.py, as a torch nn.Module.
torch's own registries, train/eval and state_dict do the work of the
JAX package's hand-written ones, and its state_dict names are the same:
parameters first, then sublayers, joined by dots
(`ernie.encoder.0.attention.qkv.weight`, bare `mlm_bias`). So a JAX
model's state_dict carries over by name (models/convert.py).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core import dtypes as _dtypes
from ...core.generator import default_generator
from ...core.place import resolve_device
from ...serialization import from_numpy
from ..initializer import Constant, Initializer, XavierNormal

__all__ = ["Layer"]


class Layer(nn.Module):
    """nn.Module with Paddle's parameter factory and state-dict loader.

    `device` is resolved the first time the layer asks for it (to make a
    parameter or a buffer): None means the current device, which is the
    CUDA card unless the CPU was asked for. A layer that holds no tensor
    (a container, an activation, a pool) never asks.
    """

    def __init__(self, dtype="float32", device=None):
        super().__init__()
        self._dtype = _dtypes.convert_dtype(dtype)
        self._device_arg = device
        self._resolved_device = None

    @property
    def _device(self) -> torch.device:
        if self._resolved_device is None:
            self._resolved_device = resolve_device(self._device_arg)
        return self._resolved_device

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer: Optional[Initializer] = None):
        """Parameter factory (the JAX Layer.create_parameter): `attr` may
        be None, False (no bias), a ParamAttr (its initializer and
        trainable) or an Initializer. An initializer given by `attr` wins;
        else set_global_initializer's default, when set, overrides the
        layer's. Biases default to zeros, weights to XavierNormal."""
        from ..param_attr import ParamAttr
        if attr is False and is_bias:
            return None
        from .. import initializer as _init_mod
        trainable = True
        if isinstance(attr, ParamAttr):
            trainable = attr.trainable
            attr = attr.initializer
        if isinstance(attr, Initializer):
            init = attr
        else:
            init = _init_mod._global_default(is_bias) or default_initializer
        if init is None:
            init = Constant(0.0) if is_bias else XavierNormal()
        dtype = _dtypes.convert_dtype(dtype) if dtype else self._dtype
        data = init(tuple(int(s) for s in shape), dtype, self._device,
                    default_generator(self._device))
        return nn.Parameter(data, requires_grad=trainable)

    @torch.no_grad()
    def set_state_dict(self, state_dict):
        """Copy `state_dict` (tensors or numpy arrays) into this layer by
        name. Returns (missing, unexpected) like Paddle; a shape mismatch
        raises."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            src = v if isinstance(v, torch.Tensor) else \
                from_numpy(np.array(v, copy=True))
            if tuple(src.shape) != tuple(own[k].shape):
                raise ValueError(
                    f"{k}: shape {tuple(src.shape)} does not match the "
                    f"layer's {tuple(own[k].shape)}")
            own[k].copy_(src)
        return missing, unexpected
