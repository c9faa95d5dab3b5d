"""Search and sort ops (counterpart of paddle_tpu/ops/search.py).

Index results are int64 (argmax/argmin take a dtype). The JAX package
runs with x64 off, so there an "int64" request gives int32
(paddle_tpu/ops/search.py:25-29); the values agree. Ties sort stably, as
jnp's sorts do. nonzero runs on the host, as in the JAX package.
"""
from __future__ import annotations

import torch

from ..core import dtypes as _dtypes
from ._args import axis_of, scalar_of, tensor_of

__all__ = [
    "argmax", "argmin", "argsort", "sort", "topk", "nonzero", "kthvalue",
    "mode", "median", "nanmedian", "quantile", "nanquantile", "searchsorted",
    "index_of_max",
]


def _arg(fn, x, axis, keepdim, dtype):
    x = tensor_of(x)
    if axis is None:
        out = fn(x.reshape(-1), 0)
    else:
        out = fn(x, int(axis), keepdim=keepdim)
    return out.to(_dtypes.convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, name=None):
    return torch.argsort(tensor_of(x), dim=axis, descending=descending,
                         stable=True)


def sort(x, axis=-1, descending=False, name=None):
    return torch.sort(tensor_of(x), dim=axis, descending=descending,
                      stable=True)[0]


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """(values, int64 indices) of the k largest (or smallest) along
    axis, in order."""
    x = tensor_of(x)
    k = int(scalar_of(k))
    if x.dim() == 0:
        x = x.reshape(1)
    vals, idx = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return vals, idx


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """(the k-th smallest value, its index) along axis."""
    x = tensor_of(x)
    k = int(scalar_of(k))
    svals, sidx = torch.sort(x, dim=axis, stable=True)
    vals = svals.narrow(axis, k - 1, 1)
    idx = sidx.narrow(axis, k - 1, 1)
    if not keepdim:
        vals, idx = vals.squeeze(axis), idx.squeeze(axis)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """(the most frequent value, the index of its last occurrence) along
    axis; among equally frequent values the smallest (the JAX package's
    sorted run-length count)."""
    x = tensor_of(x)
    x_m = torch.movedim(x, axis, -1)
    sorted_v = torch.sort(x_m, dim=-1)[0]
    counts = (sorted_v[..., :, None] == sorted_v[..., None, :]).sum(-1)
    best = torch.argmax(counts, dim=-1)
    vals = torch.take_along_dim(sorted_v, best[..., None], -1)[..., 0]
    ar = torch.arange(x_m.shape[-1], device=x.device)
    idx = torch.amax(torch.where(x_m == vals[..., None], ar,
                                 torch.full_like(ar, -1)), dim=-1)
    if keepdim:
        return (torch.movedim(vals[..., None], -1, axis),
                torch.movedim(idx[..., None], -1, axis))
    return vals, idx


def _quantile(fn, x, q, axis, keepdim, interpolation):
    """fn (torch.quantile or nanquantile) over `axis`: None, an int, or
    several dims (moved last and merged into one)."""
    x = tensor_of(x)
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    ax = axis_of(axis)
    if not isinstance(ax, tuple):
        return fn(x, qt, dim=ax, keepdim=keepdim,
                  interpolation=interpolation)
    nd = x.dim()
    ax = sorted(a % nd for a in ax)
    rest = [d for d in range(nd) if d not in ax]
    flat = x.permute(*rest, *ax).reshape(*[x.shape[d] for d in rest], -1)
    out = fn(flat, qt, dim=-1, interpolation=interpolation)
    if keepdim:
        for a in ax:
            out = out.unsqueeze(a + qt.dim())
    return out


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """The middle value; with an even count the mean of the two middle
    ones (jnp.median)."""
    return _quantile(torch.quantile, x, 0.5, axis, keepdim, "midpoint")


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim, "midpoint")


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim, "linear")


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq = tensor_of(sorted_sequence)
    return torch.searchsorted(seq, tensor_of(values, like=seq),
                              out_int32=out_int32, right=right)


def nonzero(x, as_tuple=False):
    """[n, ndim] int64 indices of the nonzero elements; as_tuple: one
    [n, 1] tensor per dim (the JAX package's shape)."""
    x = tensor_of(x)
    if as_tuple:
        return tuple(i[:, None] for i in torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def index_of_max(x, axis=None):
    return argmax(x, axis=axis)
