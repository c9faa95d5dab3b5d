"""nn.utils: weight_norm / spectral_norm (counterpart of
paddle_tpu/nn/utils.py; python/paddle/nn/utils/ parity).

Each reparameterises a layer's parameter by a forward pre-hook that
recomputes the effective weight before every forward and holds it as a
buffer under the parameter's old name, so the layer's forward reads it
unchanged. The new parameters keep the JAX package's names
(`weight_g`/`weight_v`; `weight_orig` and the `weight_sn` sublayer), so
load_jax_params carries them."""
from __future__ import annotations

import torch
from torch import nn

from .layer.layers import Layer

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm"]


def _norm_except(w, dim):
    axes = tuple(i for i in range(w.dim()) if i != dim)
    return torch.sqrt((w * w).sum(axes, keepdim=True))


def weight_norm(layer: Layer, name="weight", dim=0):
    """Reparameterise layer.<name> as g * v / ||v|| (the norm over every
    axis but `dim`): parameters <name>_g [w.shape[dim]] and <name>_v."""
    w = getattr(layer, name)
    dim = dim if dim is not None else 0
    g = nn.Parameter(_norm_except(w.detach(), dim).reshape(-1))
    v = nn.Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.register_parameter(name + "_g", g)
    layer.register_parameter(name + "_v", v)

    def hook(lyr, inputs):
        gv = lyr._parameters[name + "_g"]
        vv = lyr._parameters[name + "_v"]
        shape = [1] * vv.dim()
        shape[dim] = -1
        lyr._buffers[name] = vv / _norm_except(vv, dim) * gv.reshape(shape)
        return None

    layer._weight_norm_hook = layer.register_forward_pre_hook(hook)
    # materialise once so the attribute exists before the first forward
    hook(layer, ())
    return layer


def remove_weight_norm(layer: Layer, name="weight"):
    """Fold g and v back into one parameter <name> (its current value)."""
    h = layer.__dict__.pop("_weight_norm_hook", None)
    if h is not None:
        h.remove()
    w_eff = layer._buffers.pop(name, None)
    layer._parameters.pop(name + "_g", None)
    layer._parameters.pop(name + "_v", None)
    if w_eff is not None:
        layer.register_parameter(name, nn.Parameter(w_eff.detach()))
    return layer


def spectral_norm(layer: Layer, name="weight", n_power_iterations=1,
                  eps=1e-12, dim=None):
    """Reparameterise layer.<name> as <name>_orig / sigma, sigma from the
    SpectralNorm sublayer <name>_sn's power iterations."""
    from .layer.norm import SpectralNorm
    w = getattr(layer, name)
    dim = dim if dim is not None else 0
    sn = SpectralNorm(list(w.shape), dim=dim, power_iters=n_power_iterations,
                      eps=eps, device=w.device)
    layer.add_module(name + "_sn", sn)
    orig = nn.Parameter(w.detach().clone())
    del layer._parameters[name]
    layer.register_parameter(name + "_orig", orig)

    def hook(lyr, inputs):
        lyr._buffers[name] = lyr._modules[name + "_sn"](
            lyr._parameters[name + "_orig"])
        return None

    layer.register_forward_pre_hook(hook)
    hook(layer, ())
    return layer
