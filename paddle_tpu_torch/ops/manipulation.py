"""Shape, layout and indexing ops (counterpart of
paddle_tpu/ops/manipulation.py).

Paddle's meanings, which differ from torch's methods of the same name
(ops/__init__.py lists them): reshape's 0 copies the input's dim,
transpose takes a permutation, split takes a section count or sizes,
gather is an index_select that keeps the index's shape, scatter writes
rows, flatten takes start_axis/stop_axis, squeeze drops only the named
dims of size 1, expand's -1 keeps a dim, view(dtype) casts. The ops the
JAX package runs eagerly on the host (unique, unique_consecutive,
masked_select) run in numpy here too and put their result on the input's
device.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as TF

from ..core import dtypes as _dtypes
from ._args import scalar_of, shape_of, tensor_of

__all__ = [
    "broadcast_shape", "rank", "shape",
    "reshape", "transpose", "concat", "split", "chunk", "stack", "unstack",
    "squeeze", "unsqueeze", "flatten", "gather", "gather_nd", "scatter",
    "scatter_nd", "scatter_nd_add", "slice", "strided_slice", "expand",
    "expand_as", "broadcast_to", "broadcast_tensors", "tile", "flip", "roll",
    "cast", "unique", "unique_consecutive", "masked_select", "index_select",
    "index_sample", "where", "pad", "repeat_interleave", "take_along_axis",
    "put_along_axis", "unbind", "moveaxis", "swapaxes", "as_real",
    "as_complex", "tensordot", "unfold", "view", "view_as", "atleast_1d",
    "atleast_2d", "atleast_3d", "crop", "tolist", "rot90_", "shard_index",
    "reverse", "t",
]


def _index(index, like):
    """An index argument as an int64 tensor on `like`'s device."""
    return tensor_of(index, like=like).to(device=like.device,
                                          dtype=torch.int64)


def reshape(x, shape, name=None):
    x = tensor_of(x)
    shape = tuple(x.shape[i] if s == 0 else s
                  for i, s in enumerate(shape_of(shape)))
    return torch.reshape(x, shape)


def transpose(x, perm=None, name=None):
    x = tensor_of(x)
    perm = tuple(perm) if perm is not None else tuple(
        reversed(range(x.dim())))
    return x.permute(*perm)


def t(x, name=None):
    x = tensor_of(x)
    return x.transpose(-1, -2) if x.dim() >= 2 else x


def moveaxis(x, source, destination, name=None):
    return torch.movedim(tensor_of(x), source, destination)


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(tensor_of(x), axis0, axis1)


def concat(x, axis=0, name=None):
    return torch.cat([tensor_of(a) for a in x], int(scalar_of(axis)))


def split(x, num_or_sections, axis=0, name=None):
    """A list: num_or_sections equal parts (an int), or parts of the
    given sizes (one of them may be -1: the rest)."""
    x = tensor_of(x)
    axis = int(scalar_of(axis))
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError(
                f"split: dim {axis} of size {x.shape[axis]} does not "
                f"divide into {num_or_sections} equal sections")
        return list(torch.split(x, x.shape[axis] // num_or_sections, axis))
    sections = [int(scalar_of(s)) for s in num_or_sections]
    if -1 in sections:
        known = builtins.sum(s for s in sections if s != -1)
        sections[sections.index(-1)] = x.shape[axis] - known
    return list(torch.split(x, sections, axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis=axis)


def stack(x, axis=0, name=None):
    return torch.stack([tensor_of(a) for a in x], axis)


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(tensor_of(x), axis))


def unbind(input, axis=0):
    return unstack(input, axis=axis)


def squeeze(x, axis=None, name=None):
    """Without axis every dim of size 1 goes; with an axis (or a list)
    only those of them that have size 1."""
    x = tensor_of(x)
    if axis is None:
        return torch.squeeze(x)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(a for a in axes if x.shape[a] == 1)
    return torch.squeeze(x, axes) if axes else x


def _unsqueeze_shape(shape, axis):
    axes = (int(scalar_of(axis)),) if not isinstance(axis, (list, tuple)) \
        else tuple(int(scalar_of(a)) for a in axis)
    nd = len(shape) + len(axes)
    axes = sorted(a % nd for a in axes)
    out, it = [], iter(shape)
    for i in range(nd):
        out.append(1 if i in axes else next(it))
    return tuple(out)


def unsqueeze(x, axis, name=None):
    x = tensor_of(x)
    return x.reshape(_unsqueeze_shape(tuple(x.shape), axis))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = tensor_of(x)
    nd = x.dim()
    start = start_axis % nd if nd else 0
    stop = stop_axis % nd if nd else 0
    shape = tuple(x.shape)
    new = shape[:start] + (int(np.prod(shape[start:stop + 1], dtype=np.int64))
                           if stop >= start else 1,) + shape[stop + 1:]
    return x.reshape(new)


def cast(x, dtype):
    return tensor_of(x).to(_dtypes.convert_dtype(dtype))


def gather(x, index, axis=0, name=None):
    """x's slices `index` along axis; the index's shape replaces that dim
    (jnp.take; a 0-d index counts as [index])."""
    x = tensor_of(x)
    axis = int(scalar_of(axis)) % x.dim()
    idx = _index(index, x)
    if idx.dim() == 0:
        idx = idx[None]
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


def gather_nd(x, index, name=None):
    x = tensor_of(x)
    idx = _index(index, x)
    return x[tuple(torch.movedim(idx, -1, 0))]


def scatter(x, index, updates, overwrite=True, name=None):
    """x with rows `index` (along dim 0) set to `updates`; without
    overwrite the rows are zeroed first and the updates added."""
    x = tensor_of(x)
    idx = _index(index, x).reshape(-1)
    updates = tensor_of(updates, like=x).to(x.dtype)
    if overwrite:
        return x.index_put((idx,), updates)
    zeroed = x.index_put((idx,), torch.zeros_like(updates))
    return zeroed.index_put((idx,), updates, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x = tensor_of(x)
    idx = _index(index, x)
    return x.index_put(tuple(torch.movedim(idx, -1, 0)),
                       tensor_of(updates, like=x).to(x.dtype),
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    updates = tensor_of(updates)
    z = torch.zeros(shape_of(shape), dtype=updates.dtype,
                    device=updates.device)
    return scatter_nd_add(z, index, updates)


def slice(input, axes, starts, ends, name=None):
    x = out = tensor_of(input)
    for ax, st, en in zip(axes, starts, ends):
        st, en = int(scalar_of(st)), int(scalar_of(en))
        dim = x.shape[ax]
        st = builtins.max(st + dim, 0) if st < 0 else builtins.min(st, dim)
        en = builtins.max(en + dim, 0) if en < 0 else builtins.min(en, dim)
        out = out.narrow(ax, st, builtins.max(en - st, 0))
    return out


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing per axis, negative strides included."""
    x = tensor_of(x)
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        sl = builtins.slice(int(scalar_of(st)), int(scalar_of(en)),
                            int(scalar_of(sd)))
        keep = list(range(x.shape[ax]))[sl]
        x = torch.index_select(x, ax, torch.tensor(keep, dtype=torch.int64,
                                                   device=x.device))
    return x


def expand(x, shape, name=None):
    x = tensor_of(x)
    shape = shape_of(shape)
    pad = len(shape) - x.dim()
    return x.expand(tuple(x.shape[i - pad] if s == -1 else s
                          for i, s in enumerate(shape)))


def expand_as(x, y, name=None):
    return expand(x, list(tensor_of(y).shape))


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(tensor_of(x), shape_of(shape))


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*[tensor_of(i) for i in inputs]))


def tile(x, repeat_times, name=None):
    return torch.tile(tensor_of(x), shape_of(repeat_times))


def flip(x, axis, name=None):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(tensor_of(x), axes)


def reverse(x, axis, name=None):
    return flip(x, axis)


def roll(x, shifts, axis=None, name=None):
    x = tensor_of(x)
    if axis is None:
        return torch.roll(x.reshape(-1), shifts).reshape(x.shape)
    return torch.roll(x, shifts, axis)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        raise ValueError("use paddle.nonzero for 1-arg where (eager only)")
    cond = tensor_of(condition).to(torch.bool)
    x = tensor_of(x, like=cond)
    return torch.where(cond, x, tensor_of(y, like=x))


def _pad_index(n, before, after, mode, device):
    """The source index of every output position along one axis:
    reflect mirrors without the edge, edge repeats it, wrap cycles."""
    i = np.arange(-before, n + after)
    if mode == "reflect":
        period = 2 * (n - 1)
        i = np.abs(i) % period if period else np.zeros_like(i)
        i = np.where(i >= n, period - i, i)
    elif mode == "edge":
        i = np.clip(i, 0, n - 1)
    else:
        i = i % n
    return torch.as_tensor(i, dtype=torch.int64, device=device)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """Paddle's pad: an int for every side, 2*ndim numbers (before_0,
    after_0, ...), or pairs for the spatial dims only, innermost first,
    placed by data_format. Modes constant, reflect, replicate, circular."""
    x = tensor_of(x)
    pad = [int(scalar_of(p)) for p in pad] if not isinstance(pad, int) \
        else pad
    nd = x.dim()
    if isinstance(pad, int):
        cfg = [(pad, pad)] * nd
    elif len(pad) == 2 * nd:
        cfg = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        n_spatial = len(pad) // 2
        cfg = [(0, 0)] * nd
        if data_format in ("NCHW", "NCL", "NCDHW"):
            spatial_axes = list(range(nd - n_spatial, nd))
        else:
            spatial_axes = list(range(1, 1 + n_spatial))
        for i, ax in enumerate(reversed(spatial_axes)):
            cfg[ax] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [p for pair in reversed(cfg) for p in pair]
        return TF.pad(x, flat, mode="constant", value=value)
    tmode = {"reflect": "reflect", "replicate": "edge",
             "circular": "wrap"}[mode]
    for ax, (b, a) in enumerate(cfg):
        if b or a:
            x = torch.index_select(
                x, ax, _pad_index(x.shape[ax], b, a, tmode, x.device))
    return x


def repeat_interleave(x, repeats, axis=None, name=None):
    x = tensor_of(x)
    if not isinstance(repeats, int):
        repeats = _index(repeats, x)
    return torch.repeat_interleave(x, repeats, dim=axis)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    arr = tensor_of(arr)
    return torch.take_along_dim(arr, _index(indices, arr), axis)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    arr = tensor_of(arr)
    idx = _index(indices, arr)
    vals = torch.broadcast_to(tensor_of(values, like=arr).to(arr.dtype),
                              idx.shape)
    if reduce == "assign":
        return arr.scatter(axis, idx, vals)
    if reduce == "add":
        return arr.scatter_add(axis, idx, vals)
    if reduce == "multiply":
        return arr.scatter_reduce(axis, idx, vals, "prod")
    raise ValueError(f"unknown reduce '{reduce}'")


def index_select(x, index, axis=0, name=None):
    x = tensor_of(x)
    return torch.index_select(x, axis, _index(index, x).reshape(-1))


def index_sample(x, index):
    x = tensor_of(x)
    return torch.take_along_dim(x, _index(index, x), 1)


def tensordot(x, y, axes=2, name=None):
    x = tensor_of(x)
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return torch.tensordot(x, tensor_of(y, like=x), dims=axes)


def as_real(x, name=None):
    return torch.view_as_real(tensor_of(x))


def as_complex(x, name=None):
    return torch.view_as_complex(tensor_of(x).contiguous())


def unfold(x, axis, size, step, name=None):
    """Windows of `size` every `step` along axis; the window dim last."""
    return tensor_of(x).unfold(axis, size, step)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


def view_as(x, other, name=None):
    return reshape(x, list(tensor_of(other).shape))


def _atleast(fn, inputs):
    outs = [fn(tensor_of(i)) for i in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs):
    return _atleast(torch.atleast_1d, inputs)


def atleast_2d(*inputs):
    return _atleast(torch.atleast_2d, inputs)


def atleast_3d(*inputs):
    return _atleast(torch.atleast_3d, inputs)


def crop(x, shape=None, offsets=None, name=None):
    """x[offsets : offsets + shape], each offset clamped so the window
    fits (lax.dynamic_slice)."""
    x = tensor_of(x)
    shape = shape_of(shape)
    offsets = [0] * len(shape) if offsets is None else [
        int(scalar_of(o)) for o in offsets]
    for ax, (o, s) in enumerate(zip(offsets, shape)):
        o = builtins.min(builtins.max(o, 0), x.shape[ax] - s)
        x = x.narrow(ax, o, s)
    return x


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    x = tensor_of(input)
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(x, shard_size, rounding_mode="floor") == shard_id
    return torch.where(in_shard, torch.remainder(x, shard_size),
                       torch.full_like(x, ignore_value))


# -- eager-only dynamic-shape ops -------------------------------------------

def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Sorted unique values (of x flattened when axis is None; the
    inverse then has x's shape, as numpy's). return_index, which
    torch.unique lacks, is computed on the host with numpy."""
    x = tensor_of(x)
    if return_index:
        res = np.unique(x.detach().cpu().numpy(), return_index=True,
                        return_inverse=return_inverse,
                        return_counts=return_counts, axis=axis)
        return tuple(torch.as_tensor(np.ascontiguousarray(r),
                                     device=x.device) for r in res)
    return torch.unique(x, sorted=True, return_inverse=return_inverse,
                        return_counts=return_counts, dim=axis)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """The first of each run of equal neighbours (of x flattened when
    axis is None, as is the inverse)."""
    x = tensor_of(x)
    if axis is None:
        x = x.reshape(-1)
    return torch.unique_consecutive(x, return_inverse=return_inverse,
                                    return_counts=return_counts, dim=axis)


def masked_select(x, mask, name=None):
    x = tensor_of(x)
    return torch.masked_select(x, tensor_of(mask, like=x))


def tolist(x):
    return tensor_of(x).tolist()


def rot90_(x, k, axes):
    from .math import rot90
    return rot90(x, k, axes)


def broadcast_shape(x_shape, y_shape):
    """paddle.broadcast_shape: the numpy-broadcast result shape."""
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def shape(input, name=None):
    """paddle.shape: the shape as an int32 tensor."""
    x = tensor_of(input)
    return torch.tensor(tuple(x.shape), dtype=torch.int32, device=x.device)


def rank(input, name=None):
    """paddle.rank: ndim as a 0-d int32 tensor."""
    x = tensor_of(input)
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)
