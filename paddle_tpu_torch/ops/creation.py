"""Tensor creation ops (counterpart of paddle_tpu/ops/creation.py).

Paddle's semantics over torch. A tensor made from nothing (zeros, arange,
eye, the random ops, ...) lands on the current device: the card unless
the CPU was asked for (core/place.py resolve_device; without CUDA and
without that request these raise RuntimeError). The *_like ops and the
ops of a tensor follow that tensor's device. The created tensors are
leaves that take no gradient, as in Paddle.

The JAX package runs with x64 off, so an "int64" request gives int32
there; here it gives int64. The random ops draw from the port's default
generator of the device (core/generator.py, reseeded by paddle.seed): the
same seed gives the same tensors, but not JAX's values.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtypes as _dtypes
from ..core.generator import default_generator
from ..core.place import resolve_device
from ._args import dtype_of, scalar_of, shape_of, tensor_of

__all__ = [
    "set_printoptions",
    "zeros", "ones", "full", "empty", "zeros_like", "ones_like", "full_like",
    "empty_like", "arange", "linspace", "logspace", "eye", "diag", "diagflat",
    "tril", "triu", "meshgrid", "assign", "clone_", "rand", "randn",
    "randint", "randperm", "uniform", "normal", "bernoulli", "multinomial",
    "standard_normal", "tril_indices", "triu_indices", "one_hot",
    "numel", "create_parameter",
]


def zeros(shape, dtype=None, name=None):
    return torch.zeros(shape_of(shape), dtype=dtype_of(dtype),
                       device=resolve_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(shape_of(shape), dtype=dtype_of(dtype),
                      device=resolve_device())


def full(shape, fill_value, dtype=None, name=None):
    return torch.full(shape_of(shape), scalar_of(fill_value),
                      dtype=dtype_of(dtype), device=resolve_device())


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    x = tensor_of(x)
    return torch.zeros_like(x, dtype=dtype_of(dtype, x.dtype))


def ones_like(x, dtype=None, name=None):
    x = tensor_of(x)
    return torch.ones_like(x, dtype=dtype_of(dtype, x.dtype))


def full_like(x, fill_value, dtype=None, name=None):
    x = tensor_of(x)
    return torch.full_like(x, scalar_of(fill_value),
                           dtype=dtype_of(dtype, x.dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = scalar_of(start), scalar_of(end), scalar_of(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (torch.int64 if all(isinstance(v, (int, np.integer))
                                    for v in (start, end, step))
                 else _dtypes.get_default_dtype())
    return torch.arange(start, end, step, dtype=_dtypes.convert_dtype(dtype),
                        device=resolve_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(scalar_of(start), scalar_of(stop), int(num),
                          dtype=dtype_of(dtype), device=resolve_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(scalar_of(start), scalar_of(stop), int(num),
                          base=base, dtype=dtype_of(dtype),
                          device=resolve_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    return torch.eye(num_rows, num_columns if num_columns is not None
                     else num_rows, dtype=dtype_of(dtype),
                     device=resolve_device())


def diag(x, offset=0, padding_value=0, name=None):
    x = tensor_of(x)
    d = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        mask = torch.ones(d.shape, dtype=torch.bool, device=d.device)
        mask = torch.diag(torch.diagonal(mask, offset), offset)
        return torch.where(mask, d, torch.full_like(d, padding_value))
    return d


def diagflat(x, offset=0, name=None):
    return torch.diagflat(tensor_of(x), offset)


def tril(x, diagonal=0, name=None):
    return torch.tril(tensor_of(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(tensor_of(x), diagonal)


def meshgrid(*args, **kwargs):
    arrays = [tensor_of(a) for a in (
        args[0] if len(args) == 1 and isinstance(args[0], (list, tuple))
        else args)]
    return list(torch.meshgrid(*arrays, indexing="ij"))


def assign(x, output=None):
    """A copy of x that takes no gradient; with `output`, written into it
    (set_value) and returned."""
    t = x.detach().clone() if isinstance(x, torch.Tensor) else tensor_of(x)
    if output is not None:
        output.set_value(t)
        return output
    return t


def clone_(x):
    return tensor_of(x).detach().clone()


def numel(x, name=None):
    x = tensor_of(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def one_hot(x, num_classes, name=None):
    from ..nn.functional.common import one_hot as _one_hot
    return _one_hot(tensor_of(x), num_classes)


def _indices(rc, dtype):
    return torch.as_tensor(np.stack(rc), dtype=dtype_of(dtype, torch.int64),
                           device=resolve_device())


def tril_indices(row, col, offset=0, dtype="int64"):
    return _indices(np.tril_indices(row, offset, col), dtype)


def triu_indices(row, col=None, offset=0, dtype="int64"):
    return _indices(np.triu_indices(row, offset,
                                    col if col is not None else row), dtype)


# -- random creation --------------------------------------------------------

def _gen(device, seed=0):
    """The device's default generator, or a fresh one seeded by `seed`."""
    if seed:
        g = torch.Generator(device=device)
        g.manual_seed(int(seed))
        return g
    return default_generator(device)


def rand(shape, dtype=None, name=None):
    return uniform(shape, dtype, min=0.0, max=1.0)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = resolve_device()
    out = torch.empty(shape_of(shape), dtype=dtype_of(dtype), device=dev)
    return out.uniform_(scalar_of(min), scalar_of(max),
                        generator=_gen(dev, seed))


def randn(shape, dtype=None, name=None):
    dev = resolve_device()
    return torch.randn(shape_of(shape), dtype=dtype_of(dtype), device=dev,
                       generator=_gen(dev))


standard_normal = randn


def normal(mean=0.0, std=1.0, shape=None, name=None):
    like = mean if isinstance(mean, torch.Tensor) else (
        std if isinstance(std, torch.Tensor) else None)
    dev = like.device if like is not None else resolve_device()
    if shape is None:
        shape = torch.broadcast_shapes(tuple(np.shape(
            mean.shape if isinstance(mean, torch.Tensor) else mean)),
            tuple(np.shape(std.shape if isinstance(std, torch.Tensor)
                           else std)))
        shape = [int(s) for s in shape]
    n = torch.randn(shape_of(shape), dtype=_dtypes.get_default_dtype(),
                    device=dev, generator=_gen(dev))
    return n * std + mean


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = resolve_device()
    return torch.randint(int(low), int(high), shape_of(shape),
                         dtype=dtype_of(dtype, torch.int64), device=dev,
                         generator=_gen(dev))


def randperm(n, dtype="int64", name=None):
    dev = resolve_device()
    return torch.randperm(int(n), dtype=dtype_of(dtype, torch.int64),
                          device=dev, generator=_gen(dev))


def bernoulli(x, name=None):
    x = tensor_of(x)
    return torch.bernoulli(x, generator=_gen(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    x = tensor_of(x)
    flat = x.reshape(-1, x.shape[-1])
    out = torch.multinomial(flat, num_samples, replacement,
                            generator=_gen(x.device))
    return out.reshape(*x.shape[:-1], num_samples)


def create_parameter(shape, dtype=None, name=None, default_initializer=None):
    """A Parameter of `shape` on the current device, from
    default_initializer (an nn.initializer: (shape, dtype, device,
    generator) -> tensor), else zeros."""
    dev = resolve_device()
    shape, dt = shape_of(shape), dtype_of(dtype)
    if default_initializer is not None:
        data = default_initializer(shape, dt, dev, default_generator(dev))
    else:
        data = torch.zeros(shape, dtype=dt, device=dev)
    return torch.nn.Parameter(data)


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    """paddle.set_printoptions: forwarded to torch.set_printoptions (a
    tensor's repr) and numpy.set_printoptions (its numpy())."""
    kw = {k: int(v) for k, v in (("precision", precision),
                                 ("threshold", threshold),
                                 ("edgeitems", edgeitems),
                                 ("linewidth", linewidth)) if v is not None}
    torch.set_printoptions(sci_mode=sci_mode, **kw)
    if sci_mode is not None:
        kw["suppress"] = not bool(sci_mode)
    np.set_printoptions(**kw)
