"""Sequence ops over padded tensors and lengths (counterpart of
paddle_tpu/ops/sequence.py).

As in the JAX package, a variable-length batch is a padded `[B, T_max,
...]` tensor plus an int `length [B]` (the reference's LoD offsets made
explicit), and the ops that consumed LoD take `(x, length)`. Masks come
from sequence_mask; reductions run over the whole padded tensor under
the mask.
"""
from __future__ import annotations

import torch

from ..core.dtypes import convert_dtype
from ._args import tensor_of

__all__ = [
    "sequence_mask", "sequence_pad", "sequence_unpad", "sequence_pool",
    "sequence_first_step", "sequence_last_step", "sequence_softmax",
    "sequence_expand", "sequence_expand_as", "sequence_reverse",
    "sequence_concat", "sequence_slice", "sequence_reshape",
    "sequence_enumerate",
]


def _ints(x, like=None):
    return tensor_of(x, like).reshape(-1).to(torch.int64)


def _bcast(mask, ndim):
    """A [B, T] mask with trailing unit dims up to ndim."""
    return mask.reshape(mask.shape + (1,) * (ndim - mask.dim()))


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[B] lengths -> [B, maxlen] 0/1 mask (ref sequence_mask_op.h);
    maxlen None takes the longest length."""
    x = tensor_of(x)
    if maxlen is None:
        maxlen = int(x.max())
    rng = torch.arange(int(maxlen), dtype=x.dtype, device=x.device)
    return (rng < x[..., None]).to(convert_dtype(dtype))


def sequence_pad(x, pad_value, length, maxlen=None, name=None):
    """Packed [sum(L), ...] + lengths [B] -> ([B, maxlen, ...], length)
    (ref sequence_pad_op; the inverse of sequence_unpad)."""
    length = _ints(length, x)
    if maxlen is None:
        maxlen = int(length.max())
    starts = torch.cumsum(length, 0) - length
    pos = torch.arange(int(maxlen), device=x.device)
    idx = (starts[:, None] + pos).clamp(0, x.shape[0] - 1)
    out = x[idx]
    mask = _bcast(pos[None, :] < length[:, None], out.dim())
    pad = torch.as_tensor(pad_value, dtype=x.dtype, device=x.device)
    return torch.where(mask, out, pad), length


def sequence_unpad(x, length, name=None):
    """[B, T, ...] + lengths -> packed [sum(L), ...] (a shape the lengths
    decide: read on the host)."""
    lens = _ints(length, x).tolist()
    return torch.cat([x[i, :n] for i, n in enumerate(lens)], dim=0)


def sequence_pool(x, pool_type, length=None, is_test=False, pad_value=0.0,
                  name=None):
    """Masked pooling over the time axis of [B, T, ...]: sum, average,
    sqrt, max, min, last or first; an empty sequence gives pad_value
    (ref sequence_pool_op.h)."""
    b, t = x.shape[0], x.shape[1]
    if length is None:
        length = torch.full((b,), t, dtype=torch.int64, device=x.device)
    length = _ints(length, x)
    mask = _bcast(torch.arange(t, device=x.device)[None, :]
                  < length[:, None], x.dim())
    maskf = mask.to(x.dtype)
    lf = _bcast(length.to(x.dtype).clamp(min=1)[:, None], x.dim() - 1)
    pt = pool_type.lower()
    if pt == "sum":
        out = (x * maskf).sum(1)
    elif pt == "average":
        out = (x * maskf).sum(1) / lf
    elif pt == "sqrt":
        out = (x * maskf).sum(1) / torch.sqrt(lf)
    elif pt == "max":
        out = torch.where(mask, x, float("-inf")).amax(1)
    elif pt == "min":
        out = torch.where(mask, x, float("inf")).amin(1)
    elif pt == "last":
        idx = (length - 1).clamp(min=0)
        out = x[torch.arange(b, device=x.device), idx]
    elif pt == "first":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pool_type {pool_type!r}")
    empty = (length == 0).reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(empty, torch.as_tensor(pad_value, dtype=x.dtype,
                                              device=x.device), out)


def sequence_first_step(x, length=None, name=None):
    return sequence_pool(x, "first", length)


def sequence_last_step(x, length=None, name=None):
    return sequence_pool(x, "last", length)


def sequence_softmax(x, length=None, name=None):
    """Masked softmax over the time axis of [B, T] or [B, T, 1]; padded
    positions give 0."""
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    z = x[..., 0] if squeeze else x
    t = z.shape[1]
    if length is None:
        length = torch.full((z.shape[0],), t, dtype=torch.int64,
                            device=x.device)
    mask = torch.arange(t, device=x.device)[None, :] \
        < _ints(length, x)[:, None]
    out = torch.softmax(torch.where(mask, z, float("-inf")), dim=1)
    out = torch.where(mask, out, torch.zeros_like(out))
    return out[..., None] if squeeze else out


def sequence_reverse(x, length=None, name=None):
    """The valid prefix of each row of [B, T, ...] reversed in time
    (ref sequence_reverse_op.h); padding stays in place."""
    t = x.shape[1]
    if length is None:
        return torch.flip(x, dims=(1,))
    length = _ints(length, x)
    pos = torch.arange(t, device=x.device)[None, :]
    idx = torch.where(pos < length[:, None], length[:, None] - 1 - pos, pos)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def sequence_expand(x, y_length, ref_level=0, name=None):
    """Row i of x [B, ...] repeated y_length[i] times and padded:
    [B, max(y_length), ...] (the padded form of ref sequence_expand_op)."""
    y_length = _ints(y_length, x)
    max_rep = int(y_length.max())
    out = x[:, None].expand((x.shape[0], max_rep) + tuple(x.shape[1:]))
    mask = torch.arange(max_rep, device=x.device)[None, :] \
        < y_length[:, None]
    return out * _bcast(mask, out.dim()).to(x.dtype)


def sequence_expand_as(x, y, name=None):
    """Row i of x [B, ...] over y's time axis: [B, T, ...]."""
    t = y.shape[1]
    return x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:])).clone()


def sequence_concat(xs, lengths=None, name=None):
    """Concatenation in time of [B, Ti, ...] tensors, each row's valid
    prefixes packed one after the other when lengths are given: returns
    ([B, sum(Ti), ...], length)."""
    xs = list(xs)
    if lengths is None:
        out = torch.cat(xs, dim=1)
        return out, torch.full((out.shape[0],), out.shape[1],
                               dtype=torch.int32, device=out.device)
    lengths = [_ints(n, xs[0]) for n in lengths]
    b = xs[0].shape[0]
    t_out = sum(int(x.shape[1]) for x in xs)
    out = xs[0].new_zeros((b, t_out + 1) + tuple(xs[0].shape[2:]))
    offset = torch.zeros((b,), dtype=torch.int64, device=out.device)
    rows = torch.arange(b, device=out.device)[:, None]
    for x, n in zip(xs, lengths):
        pos = torch.arange(x.shape[1], device=out.device)[None, :]
        # invalid positions land in the scratch column t_out, dropped
        dst = torch.where(pos < n[:, None], offset[:, None] + pos, t_out)
        out = out.index_put((rows.expand(dst.shape), dst), x.to(out.dtype))
        offset = offset + n
    return out[:, :t_out], sum(lengths)


def sequence_slice(x, offset, length, name=None):
    """Row i's time steps [offset[i], offset[i] + length[i]) of [B, T,
    ...], padded to [B, max(length), ...] (ref sequence_slice_op.h)."""
    offset = _ints(offset, x)
    length = _ints(length, x)
    max_l = int(length.max())
    pos = torch.arange(max_l, device=x.device)[None, :]
    idx = (offset[:, None] + pos).clamp(0, x.shape[1] - 1)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    out = torch.gather(x, 1, idx.expand((x.shape[0], max_l)
                                        + tuple(x.shape[2:])))
    return out * _bcast(pos < length[:, None], out.dim()).to(x.dtype)


def sequence_reshape(x, new_dim, name=None):
    """[B, T, D] -> [B, T * D / new_dim, new_dim]."""
    return x.reshape(x.shape[0], -1, int(new_dim))


def sequence_enumerate(x, win_size, pad_value=0, name=None):
    """Sliding windows over time: [B, T] ids -> [B, T, win_size], the
    positions past the end pad_value (ref sequence_enumerate_op.h)."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[:, None] + \
        torch.arange(int(win_size), device=x.device)[None, :]
    out = x[:, pos.clamp(max=t - 1)]
    return torch.where((pos < t)[None], out,
                       torch.as_tensor(pad_value, dtype=x.dtype,
                                       device=x.device))
