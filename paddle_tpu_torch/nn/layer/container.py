"""Containers (counterpart of paddle_tpu/nn/layer/container.py).

Each is a Layer whose sublayers (or parameters) are registered under the
JAX package's names, "0", "1", ... or the names given, so a model's
state_dict names (`layer1.0.conv1.weight`) equal the JAX model's and
models/convert.py load_jax_params copies by name.
"""
from __future__ import annotations

from typing import Iterable

from torch import nn

from .layers import Layer

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(Layer):
    """Sequential(l0, l1, ...) names its sublayers "0", "1", ...;
    Sequential([(name, layer), ...]) or Sequential((name, layer), ...)
    by the names given."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], tuple):
            for name, layer in layers[0]:
                self.add_module(str(name), layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_module(str(layer[0]), layer[1])
                else:
                    self.add_module(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers: Iterable[nn.Module] = None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_module(str(i), layer)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._modules.values())[idx])
        return list(self._modules.values())[idx]

    def __setitem__(self, idx, layer):
        keys = list(self._modules)
        self._modules[keys[idx]] = layer

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_module(str(len(self._modules)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, lyr in enumerate(layers):
            self._modules[str(i)] = lyr

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    def __init__(self, parameters: Iterable[nn.Parameter] = None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.register_parameter(str(i), p)

    def __len__(self):
        return len(self._parameters)

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self.register_parameter(str(len(self._parameters)), parameter)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers:
            self.update(sublayers)

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_module(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __contains__(self, key):
        return key in self._modules

    def __iter__(self):
        return iter(self._modules)

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def update(self, sublayers):
        items = sublayers.items() if hasattr(sublayers, "items") else \
            sublayers
        for key, layer in items:
            self.add_module(key, layer)
        return self
