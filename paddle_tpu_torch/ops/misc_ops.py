"""The reference's long-tail ops (counterpart of
paddle_tpu/ops/misc_ops.py): partial/slab utilities, positional
encoding, time-axis convolutions, parameter-server id sharding, SPP,
sequence conv/scatter, debug print. Each is the JAX package's function in
torch ops; the ones whose output shape the data decides (filter_by_instag,
split_ids, merge_ids, split_selected_rows) run on the host as there.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.selected_rows import SelectedRows
from ._args import tensor_of

__all__ = [
    "print_op", "select_input", "select_output", "partial_concat",
    "partial_sum", "pad_constant_like", "space_to_depth", "conv_shift",
    "row_conv", "add_position_encoding", "shuffle_batch",
    "filter_by_instag", "merge_ids", "split_ids", "split_selected_rows",
    "get_tensor_from_selected_rows", "spp", "sequence_conv",
    "sequence_scatter", "sequence_topk_avg_pooling", "l1_norm",
    "squared_l2_norm", "squared_l2_distance",
]


def print_op(x, message="", first_n=-1, summarize=20, print_phase="both",
             name=None):
    """Identity that prints its input (ref print_op.cc): the shape and
    the first `summarize` values (every value when negative)."""
    flat = x.detach().reshape(-1).cpu()
    shown = flat if summarize < 0 else flat[:summarize]
    print(f"{message}shape={tuple(x.shape)} values={shown.tolist()}")
    return x


def select_input(inputs, mask):
    """inputs[mask] (ref select_input_op.cc), the index clamped into the
    list; selected on the device (every input must share shape and
    dtype, as the JAX op's lax.switch requires)."""
    xs = list(inputs)
    idx = torch.as_tensor(mask).reshape(()).to(xs[0].device, torch.int64)
    idx = idx.clamp(0, len(xs) - 1)
    out = xs[0]
    for i in range(1, len(xs)):
        out = torch.where(idx == i, xs[i], out)
    return out


def select_output(x, mask, n_out=2):
    """x routed to output[mask]; the other outputs are zeros of x's shape
    (ref select_output_op.cc)."""
    idx = torch.as_tensor(mask).reshape(()).to(torch.int64).to(x.device)
    return tuple(torch.where(idx == i, x, torch.zeros_like(x))
                 for i in range(int(n_out)))


def _cols(m, start_index, length):
    s = start_index if start_index >= 0 else m + start_index
    return s, (m if length < 0 else s + length)


def partial_concat(x, start_index=0, length=-1, name=None):
    """The columns [start, start + length) of each [B, M] input,
    concatenated (ref partial_concat_op.cc)."""
    xs = list(x)
    s, e = _cols(xs[0].shape[1], int(start_index), int(length))
    return torch.cat([t[:, s:e] for t in xs], dim=1)


def partial_sum(x, start_index=0, length=-1, name=None):
    """The sum over inputs of their columns [start, start + length) (ref
    partial_sum_op.cc)."""
    xs = list(x)
    s, e = _cols(xs[0].shape[1], int(start_index), int(length))
    out = xs[0][:, s:e]
    for t in xs[1:]:
        out = out + t[:, s:e]
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    """y padded at the end of every dim up to x's shape (ref
    pad_constant_like_op.cc)."""
    pads = []
    for xs, ys in reversed(list(zip(x.shape, y.shape))):
        pads += [0, int(xs) - int(ys)]
    return torch.nn.functional.pad(y, pads, value=float(pad_value))


def space_to_depth(x, blocksize, name=None):
    """NCHW [N, C, H, W] -> [N, C*b*b, H/b, W/b] (ref
    space_to_depth_op.cc)."""
    b = int(blocksize)
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


def conv_shift(x, y, name=None):
    """Circular convolution (ref conv_shift_op.cc): x [B, M], y [B, N],
    N odd; out[b, i] = sum_j x[b, (i + j - N//2) mod M] y[b, j]."""
    m, n = x.shape[1], y.shape[1]
    idx = (torch.arange(m, device=x.device)[:, None]
           + torch.arange(n, device=x.device)[None, :] - n // 2) % m
    return torch.einsum("bmn,bn->bm", x[:, idx], y)


def row_conv(x, filt, name=None):
    """Lookahead row convolution (ref row_conv_op.cc): x [B, T, D],
    filter [k, D]; out[b, t, d] = sum_{j<k, t+j<T} x[b, t+j, d] f[j, d]."""
    k, t = filt.shape[0], x.shape[1]
    padded = torch.nn.functional.pad(x, (0, 0, 0, k - 1))
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + padded[:, j:j + t, :] * filt[j][None, None, :]
    return out


def add_position_encoding(x, alpha=1.0, beta=1.0, name=None):
    """alpha x + beta PE, PE the reference's half-split sinusoid (first
    half sin, second half cos; add_position_encoding_op.h)."""
    _, t, d = x.shape
    half = d // 2
    pos = torch.arange(t, dtype=x.dtype, device=x.device)[:, None]
    div = torch.pow(torch.tensor(10000.0, dtype=x.dtype, device=x.device),
                    torch.arange(half, dtype=x.dtype, device=x.device)
                    / half)
    pe = torch.cat([torch.sin(pos / div), torch.cos(pos / div)], dim=1)
    if pe.shape[1] < d:
        pe = torch.nn.functional.pad(pe, (0, d - pe.shape[1]))
    return alpha * x + beta * pe[None]


def shuffle_batch(x, seed=None, name=None):
    """A random permutation of the rows (ref shuffle_batch_op.cc):
    (x[perm], perm int32), drawn from a generator seeded with `seed`, else
    from the port's default generator of x's device (JAX's bits cannot be
    matched)."""
    from ..core.generator import default_generator
    if seed is None:
        generator = default_generator(x.device)
    else:
        generator = torch.Generator(device=x.device).manual_seed(int(seed))
    perm = torch.randperm(x.shape[0], generator=generator, device=x.device)
    return x[perm], perm.to(torch.int32)


def filter_by_instag(ins, ins_tag_lengths, ins_tags, filter_tags,
                     out_val_if_empty=0):
    """The rows whose tag set meets filter_tags (ref
    filter_by_instag_op.cc), on the host: (rows, their int64 indices,
    float32 ones), or one row of out_val_if_empty when none is kept."""
    dev = ins.device
    arr = ins.detach().cpu().numpy()
    tags = tensor_of(ins_tags).cpu().numpy().ravel()
    lens = tensor_of(ins_tag_lengths).cpu().numpy().ravel()
    fset = {int(t) for t in tensor_of(filter_tags).cpu().numpy().ravel()}
    keep, off = [], 0
    for i, n in enumerate(lens):
        if fset.intersection(int(t) for t in tags[off:off + int(n)]):
            keep.append(i)
        off += int(n)
    if not keep:
        out = np.full((1,) + arr.shape[1:], out_val_if_empty, arr.dtype)
        return (torch.as_tensor(out, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev),
                torch.zeros(1, dtype=torch.float32, device=dev))
    idx = torch.as_tensor(keep, dtype=torch.int64, device=dev)
    return (ins[idx], idx, torch.ones(len(keep), dtype=torch.float32,
                                      device=dev))


def split_ids(ids, shard_num):
    """The ids of each shard `id % shard_num`, in order (ref
    split_ids_op.cc): a list of tensors."""
    ids = ids.reshape(-1)
    return [ids[ids % shard_num == s] for s in range(int(shard_num))]


def merge_ids(ids, rows, values):
    """The inverse of split_ids for looked-up rows (ref merge_ids_op.cc):
    the shards' rows back in the order of ids (zeros for an id no shard
    holds; the last shard that holds an id wins)."""
    ids = ids.reshape(-1)
    out = values[0].new_zeros((ids.shape[0], values[0].shape[-1]))
    for shard_rows, shard_vals in zip(rows, values):
        r = shard_rows.reshape(-1)
        hit = ids[:, None] == r[None, :]
        found = hit.any(1)
        # the last matching position in the shard, as a dict of id -> row
        pos = (hit * torch.arange(1, r.shape[0] + 1,
                                  device=ids.device)).argmax(1)
        out = torch.where(found[:, None], shard_vals[pos].to(out.dtype),
                          out)
    return out


def split_selected_rows(sr, height_sections):
    """A SelectedRows split by contiguous height sections (ref
    split_selected_rows_op.cc), each with its rows made local."""
    outs, start = [], 0
    for h in height_sections:
        m = (sr.rows >= start) & (sr.rows < start + h)
        outs.append(SelectedRows(sr.rows[m] - start, sr.value[m], int(h)))
        start += h
    return outs


def get_tensor_from_selected_rows(sr):
    """The value slab of a SelectedRows (ref
    get_tensor_from_selected_rows_op.cc)."""
    return sr.value


def spp(x, pyramid_height=3, pooling_type="max", name=None):
    """Spatial pyramid pooling (ref spp_op.cc): adaptive pools at 1x1,
    2x2, ..., 2^(h-1) bins, flattened and concatenated: [N, C *
    sum(4^l)]."""
    from ..nn.functional.pooling import _adaptive
    n, c = x.shape[0], x.shape[1]
    outs = []
    for level in range(int(pyramid_height)):
        bins = 2 ** level
        p = _adaptive(x, (bins, bins), 2, False,
                      "max" if pooling_type == "max" else "avg")
        outs.append(p.reshape(n, c * bins * bins))
    return torch.cat(outs, dim=1)


def sequence_conv(x, filt, length=None, context_length=3, context_start=None,
                  name=None):
    """A context-window linear map per time step (ref
    sequence_conv_op.cc): x [B, T, D], filter [context_length * D, M];
    window rows outside [0, T), or past `length`, are zeros."""
    cl = int(context_length)
    start = -((cl - 1) // 2) if context_start is None else int(context_start)
    t = x.shape[1]
    tpos = torch.arange(t, device=x.device)
    cols = []
    for j in range(cl):
        off = start + j
        shifted = torch.roll(x, -off, dims=1)
        pos = tpos + off
        valid = (pos >= 0) & (pos < t)
        if length is not None:
            valid = valid[None, :] & (pos[None, :] <
                                      tensor_of(length, x)[:, None])
            shifted = shifted * valid[:, :, None].to(x.dtype)
        else:
            shifted = shifted * valid[None, :, None].to(x.dtype)
        cols.append(shifted)
    return torch.cat(cols, dim=-1) @ filt


def sequence_scatter(x, index, updates, length=None, name=None):
    """x [B, D] plus updates [B, K] added at the columns index [B, K]
    (ref sequence_scatter_op.cc); positions past length[b] are left
    out."""
    upd = updates
    if length is not None:
        mask = torch.arange(index.shape[1], device=x.device)[None, :] \
            < tensor_of(length, x)[:, None]
        upd = upd * mask.to(updates.dtype)
    rows = torch.arange(x.shape[0], device=x.device)[:, None].expand(
        index.shape)
    return x.index_put((rows, index.long()), upd.to(x.dtype),
                       accumulate=True)


def sequence_topk_avg_pooling(x, topks=(1,), name=None):
    """The mean of the top k along the last axis, for each k of topks
    (ref sequence_topk_avg_pooling_op.cc): x [B, C, N] -> [B, C *
    len(topks)]."""
    ks = tuple(int(k) for k in topks)
    top = torch.topk(x, max(ks), dim=-1).values
    csum = torch.cumsum(top, dim=-1)
    return torch.cat([csum[..., k - 1] / k for k in ks], dim=-1)


def l1_norm(x, name=None):
    """sum(|x|) (ref l1_norm_op.cc)."""
    return torch.sum(torch.abs(x))


def squared_l2_norm(x, name=None):
    """sum(x^2) (ref squared_l2_norm_op.cc)."""
    return torch.sum(torch.square(x))


def squared_l2_distance(x, y, name=None):
    """(x - y, the row-wise |x - y|^2) (ref squared_l2_distance_op.cc);
    a y of one row is broadcast."""
    sub = x - (y if y.shape[0] == x.shape[0] else y.expand(x.shape))
    return sub, torch.sum(torch.square(sub), dim=tuple(range(1, sub.dim())))
