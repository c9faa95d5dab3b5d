"""linear, dropout, embedding, one_hot, interpolate and upsample
(counterpart of paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

import numpy as np
import torch

from ...amp.auto_cast import amp_cast
from ...core.generator import scope_generator

__all__ = ["linear", "dropout", "embedding", "one_hot", "interpolate",
           "upsample"]


def linear(x, weight, bias=None, name=None):
    """x @ weight + bias with Paddle's weight layout [in, out]. A plain
    matmul: the JAX package leaves it to XLA, the port to cuBLAS. Under
    AMP it is a white-list op ("linear"): inputs cast to bf16."""
    x, weight, bias = amp_cast("linear", x, weight, bias)
    if bias is None:
        return torch.matmul(x, weight)
    if x.dim() == 2:
        return torch.addmm(bias, x, weight)
    out = torch.addmm(bias, x.reshape(-1, x.shape[-1]), weight)
    return out.reshape(*x.shape[:-1], weight.shape[-1])


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Element dropout. The mask draws from the device's generator, or
    inside a seed_scope (a TrainStep) from one seeded by the step."""
    p = float(p)
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p) if p > 0 else x
        return x
    if axis is not None:
        raise NotImplementedError(
            "axis-structured dropout is not ported yet (a later slice)")
    keep = torch.empty(x.shape, dtype=torch.float32,
                       device=x.device).bernoulli_(
        1.0 - p, generator=scope_generator(x.device)).bool()
    scaled = x / (1.0 - p) if mode == "upscale_in_train" else x
    return torch.where(keep, scaled, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


class _Embedding(torch.autograd.Function):
    """Row gather whose backward, the sum of the output rows of each
    index (the JAX package's scatter-add), is the same bits every run.

    torch's CUDA embedding backward adds the rows of an index that
    repeats more than a few times with atomics, in an order that changes
    from run to run: ERNIE-base's position and token-type tables, whose
    rows repeat 48 and 24,576 times in a 48x512 step, took gradients
    that differed between two identical steps (chip_smoke.py's
    ernie_determinism). Under torch's deterministic mode the same
    backward sums them in a fixed order, so this backward runs in that
    mode (a host flag, read when the op is dispatched, so a captured
    graph keeps the deterministic kernels)."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x)
        ctx.rows = weight.shape[0]
        return torch.nn.functional.embedding(x, weight)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        gw = deterministic(torch.ops.aten.embedding_dense_backward,
                           g.contiguous(), x, ctx.rows, -1, False)
        return None, gw


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Row gather; rows of `padding_idx` read as zeros (Paddle's
    lookup_table_v2 semantics). Its backward is a dense sum of rows per
    index in a fixed order (_Embedding), not an index_put over the whole
    table."""
    out = _Embedding.apply(x, weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((x == padding_idx).unsqueeze(-1), 0.0)
    return out


def deterministic(fn, *args):
    """fn(*args) under torch's deterministic flag, restored after. The
    flag alone: torch.use_deterministic_algorithms also sets inductor's
    config, whose import costs a process seconds at its first backward,
    and the port compiles nothing with inductor."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch._C._set_deterministic_algorithms(True)
    try:
        return fn(*args)
    finally:
        torch._C._set_deterministic_algorithms(was, warn_only=warn)


class _TakeAlong(torch.autograd.Function):
    """x.index_select(axis, idx), whose backward (an index_add of the
    output's gradient, with repeated indices when an axis is upsampled)
    runs under torch's deterministic flag: the CUDA index_add adds a
    repeated index's rows with atomics otherwise, in an order that
    changes from run to run, and a captured step could not be bit-equal
    to its eager run."""

    @staticmethod
    def forward(ctx, x, idx, axis):
        ctx.save_for_backward(idx)
        ctx.axis, ctx.size = axis, x.shape[axis]
        return x.index_select(axis, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        shape = list(g.shape)
        shape[ctx.axis] = ctx.size
        gx = deterministic(lambda: g.new_zeros(shape).index_add_(
            ctx.axis, idx, g))
        return gx, None, None


def take_along(x, idx, axis):
    """x's slices `idx` (int64, on x's device) along `axis`, with a
    deterministic backward (_TakeAlong)."""
    return _TakeAlong.apply(x, idx, axis)


def one_hot(x, num_classes, name=None):
    """One-hot of integer `x` in the default float type (the JAX
    package's jax.nn.one_hot: an index outside [0, num_classes) gives a
    row of zeros)."""
    from ...core.dtypes import get_default_dtype
    return (x.long().unsqueeze(-1) == torch.arange(
        num_classes, device=x.device)).to(get_default_dtype())


def _f32(v):
    """A Python float rounded to float32, as JAX's weak type rounds a
    Python scalar that meets a float32 array."""
    return float(np.float32(v))


def _arange_f32(n, device):
    return torch.arange(n, dtype=torch.float32, device=device)


def _cubic_weight(t):
    """Keys' cubic kernel with a = -0.75 at |t| (the JAX package's
    integer powers: t**2 = t*t, t**3 = t*(t*t))."""
    a = -0.75
    at = t.abs()
    at2 = at * at
    at3 = at * at2
    near = (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0
    far = a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.where(at <= 1.0, near, torch.where(at < 2.0, far, zero))


def _axis_shape(nd, ax, n):
    shape = [1] * nd
    shape[ax] = n
    return shape


def _cubic_axis(x, ax, in_s, out_s, align_corners, nd):
    """Separable 1-axis bicubic resample, Keys kernel a = -0.75 with
    replicate-clamped border taps (weights always sum to 1)."""
    dev = x.device
    if align_corners:
        pos = (_arange_f32(out_s, dev) * _f32((in_s - 1) / (out_s - 1))
               if out_s > 1 else torch.zeros(out_s, device=dev))
    else:
        pos = ((_arange_f32(out_s, dev) + 0.5) * _f32(in_s / out_s)
               - 0.5)
    base = torch.floor(pos)
    frac = pos - base
    shape = _axis_shape(nd, ax, out_s)
    acc = None
    for k in (-1, 0, 1, 2):
        idx = (base.to(torch.int32) + k).clamp(0, in_s - 1).long()
        wk = _cubic_weight(frac - k).reshape(shape).to(x.dtype)
        term = take_along(x, idx, ax) * wk
        acc = term if acc is None else acc + term
    return acc


def _triangle_weights(in_s, out_s, device):
    """[in_s, out_s] weights of jax.image.resize's linear method
    (scale_and_translate's compute_weight_mat, antialias on): a triangle
    kernel widened by in/out when downsampling, each column normalised
    to sum 1, zero where the sample falls outside the input."""
    inv_scale = 1.0 / (out_s / in_s)
    kernel_scale = _f32(max(inv_scale, 1.0))
    sample = ((_arange_f32(out_s, device) + 0.5) * _f32(inv_scale)
              - 0.0 - 0.5)
    dist = (sample[None, :] - _arange_f32(in_s, device)[:, None]).abs() \
        / kernel_scale
    w = torch.clamp_min(1.0 - dist, 0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_s - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _linear_resize(x, axes, in_sizes, out_sizes):
    """jax.image.resize(x, ..., "linear"): one weight matrix per resized
    axis, contracted in turn (axes whose size stays are skipped, as
    jax.image.resize skips them)."""
    out = x
    for ax, in_s, out_s in zip(axes, in_sizes, out_sizes):
        if in_s == out_s:
            continue
        w = _triangle_weights(in_s, out_s, x.device).to(x.dtype)
        out = torch.movedim(torch.tensordot(out, w, dims=([ax], [0])),
                            -1, ax)
    return out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial axes of `x` (NC... or N...C) to `size`, or by
    `scale_factor`, with the JAX package's arithmetic for each mode:

    - nearest: source index floor(i * (in / out)) in float32, gathered
      (torch's own nearest rounds otherwise for some ratios);
    - bilinear/linear/trilinear: with align_corners, the two taps at
      i * (in - 1) / (out - 1); without, jax.image.resize's linear
      method, which antialiases (widens its triangle) when downsampling;
    - bicubic: Keys' cubic, a = -0.75, clamped taps;
    - area: adaptive average pooling."""
    channel_last = data_format[-1] == "C"
    nd = x.dim()
    n_spatial = nd - 2
    axes = (list(range(1, 1 + n_spatial)) if channel_last
            else list(range(2, 2 + n_spatial)))
    in_sizes = [x.shape[a] for a in axes]
    if size is not None:
        if isinstance(size, (int, np.integer)):
            out_sizes = [int(size)] * n_spatial
        else:
            out_sizes = [int(s) for s in size]
    else:
        sf = (list(scale_factor) if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * n_spatial)
        out_sizes = [int(in_sizes[i] * float(sf[i]))
                     for i in range(n_spatial)]
    method = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
              "trilinear": "linear", "bicubic": "cubic",
              "area": "area"}[mode]
    if method == "nearest":
        out = x
        for ax, in_s, out_s in zip(axes, in_sizes, out_sizes):
            idx = torch.floor(_arange_f32(out_s, x.device)
                              * _f32(in_s / out_s)).to(torch.int32).long()
            out = take_along(out, idx, ax)
        return out
    if method == "area":
        from .pooling import _adaptive
        return _adaptive(x, tuple(out_sizes), len(out_sizes),
                         not data_format.startswith("NC"), "avg")
    if method == "cubic":
        out = x
        for ax, in_s, out_s in zip(axes, in_sizes, out_sizes):
            out = _cubic_axis(out, ax, in_s, out_s, align_corners, nd)
        return out
    if align_corners:
        out = x
        for ax, in_s, out_s in zip(axes, in_sizes, out_sizes):
            pos = (_arange_f32(out_s, x.device) * _f32((in_s - 1)
                                                      / (out_s - 1))
                   if out_s > 1 else torch.zeros(out_s, device=x.device))
            lo = torch.floor(pos).to(torch.int32).clamp(0, in_s - 1)
            hi = (lo + 1).clamp(0, in_s - 1)
            w = (pos - lo).to(x.dtype).reshape(_axis_shape(nd, ax, out_s))
            out = (take_along(out, lo.long(), ax) * (1 - w)
                   + take_along(out, hi.long(), ax) * w)
        return out
    return _linear_resize(x, axes, in_sizes, out_sizes)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)
