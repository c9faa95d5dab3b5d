"""Pooling functionals (counterpart of paddle_tpu/nn/functional/pooling.py).

The JAX package pools with lax.reduce_window; the port calls torch's
pooling ops where they compute the same windows, and pads explicitly
where they would not:

- ceil_mode pads the high side by _ceil_extra and keeps EVERY window
  of the padded extent (a last window that starts in the padding
  included: -inf for max, 0/0 for an exclusive average, as the JAX
  package gives). torch's ceil_mode drops such a window (size 5,
  kernel 2, stride 2, padding 1: 4 windows in the JAX package, 3 in
  torch), so ceil_mode and asymmetric pads go through F.pad and a
  padding-free pool.
- "SAME"/"VALID" pads as XLA's reduce_window reads them; with a string
  padding the average divides by the window size (exclusive is not
  read), as in the JAX package.
- exclusive=True divides by the count of real elements in the window.
- max_pool2d(return_mask=True) is the JAX package's own path: torch's
  ceil clamp on the output size, first-occurrence argmax, indices into
  the flattened h*w input.
- adaptive pooling reduces axis by axis: a reshape and a mean (or max)
  where the size divides, else paddle's bin formula over overlapping
  windows (start = i*in // out, end = ceil((i+1)*in / out)). The
  reshape form also keeps torch's adaptive_avg_pool CUDA backward,
  which adds with atomics, off the path.

NLC/NHWC/NDHWC pool on the channels-first view.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

__all__ = [
    "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d", "max_pool2d",
    "max_pool3d", "adaptive_avg_pool1d", "adaptive_avg_pool2d",
    "adaptive_avg_pool3d", "adaptive_max_pool1d", "adaptive_max_pool2d",
    "adaptive_max_pool3d",
]

_MAX = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}
_AVG = {1: TF.avg_pool1d, 2: TF.avg_pool2d, 3: TF.avg_pool3d}


def _norm_tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(i) for i in v)


def _pad_pairs(padding, n):
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (int, np.integer)):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    return [(int(padding[2 * i]), int(padding[2 * i + 1])) for i in range(n)]


def _ceil_extra(size, k, s, total_pad):
    out_floor = (size + total_pad - k) // s + 1
    out_ceil = math.ceil((size + total_pad - k) / s) + 1
    return (out_ceil - out_floor) * s


def _torch_pad(pairs):
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return flat


def _channels_first(x, n, channel_last):
    return x.permute(0, n + 1, *range(1, n + 1)) if channel_last else x


def _channels_back(out, n, channel_last):
    return out.permute(0, *range(2, n + 2), 1) if channel_last else out


def _window_pads(x, ksize, stride, padding, n, ceil_mode):
    """(k, s, pads, from_string): the window, the stride and the (lo, hi)
    pads reduce_window uses on x (channels first)."""
    k = _norm_tuple(ksize, n)
    s = _norm_tuple(stride if stride is not None else ksize, n)
    pad = _pad_pairs(padding, n)
    spatial = x.shape[2:]
    if pad == "VALID":
        return k, s, [(0, 0)] * n, True
    if pad == "SAME":
        pads = []
        for size, kk, ss in zip(spatial, k, s):
            total = max((math.ceil(size / ss) - 1) * ss + kk - size, 0)
            pads.append((total // 2, total - total // 2))
        return k, s, pads, True
    if ceil_mode:
        pad = [(lo, hi + _ceil_extra(spatial[i], k[i], s[i], lo + hi))
               for i, (lo, hi) in enumerate(pad)]
    return k, s, pad, False


def _torch_padding(k, pads):
    """The symmetric padding torch's pools take for `pads`, or None
    where they cannot (asymmetric, or above half the window)."""
    if all(lo == hi and 2 * lo <= kk for (lo, hi), kk in zip(pads, k)):
        return tuple(lo for lo, _ in pads)
    return None


def _max_pool(x, ksize, stride, padding, n, channel_last, ceil_mode=False):
    x = _channels_first(x, n, channel_last)
    k, s, pads, _ = _window_pads(x, ksize, stride, padding, n, ceil_mode)
    sym = _torch_padding(k, pads)
    if sym is None:
        x = TF.pad(x, _torch_pad(pads), value=-math.inf)
        sym = 0
    return _channels_back(_MAX[n](x, k, s, sym), n, channel_last)


def _avg_pool(x, ksize, stride, padding, n, channel_last, exclusive=True,
              ceil_mode=False):
    x = _channels_first(x, n, channel_last)
    k, s, pads, from_string = _window_pads(x, ksize, stride, padding, n,
                                           ceil_mode)
    exclusive = exclusive and not from_string
    sym = _torch_padding(k, pads)
    if sym is not None:
        out = _AVG[n](x, k, s, sym, count_include_pad=not exclusive)
    else:
        xp = TF.pad(x, _torch_pad(pads))
        if not exclusive:
            out = _AVG[n](xp, k, s, 0)
        else:
            # the window's sum over the count of its real elements (both
            # as means over the window, whose size cancels)
            ones = TF.pad(torch.ones((1, 1) + tuple(x.shape[2:]),
                                     dtype=x.dtype, device=x.device),
                          _torch_pad(pads))
            out = _AVG[n](xp, k, s, 0) / _AVG[n](ones, k, s, 0)
    return _channels_back(out, n, channel_last)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCL", name=None):
    if return_mask:
        raise NotImplementedError(
            "return_mask is implemented for max_pool2d only; 1d/3d "
            "masks raise loudly rather than silently ignoring the "
            "flag")
    return _max_pool(x, kernel_size, stride, padding, 1,
                     data_format == "NLC", ceil_mode)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    if return_mask:
        if data_format != "NCHW":
            raise ValueError("return_mask=True supports NCHW only")
        return _max_pool2d_with_mask(x, kernel_size, stride, padding,
                                     ceil_mode)
    return _max_pool(x, kernel_size, stride, padding, 2,
                     data_format == "NHWC", ceil_mode)


def _pool_out_size(size, k, s, pad_lo, pad_hi, ceil_mode):
    """Output extent with the torch/Caffe ceil-mode clamp (the JAX
    package's mask path): the last window must START inside the
    input-plus-leading-pad region."""
    total = size + pad_lo + pad_hi - k
    out = (math.ceil(total / s) if ceil_mode else total // s) + 1
    if ceil_mode and (out - 1) * s >= size + pad_lo:
        out -= 1
    return int(out)


def _max_pool2d_with_mask(x, ksize, stride, padding, ceil_mode):
    """(out, mask): the max of each window and its first-occurrence index
    into the flattened h*w input map."""
    k = _norm_tuple(ksize, 2)
    s = _norm_tuple(stride if stride is not None else ksize, 2)
    pad = _pad_pairs(padding, 2)
    if isinstance(pad, str):
        raise ValueError(
            f"return_mask=True needs explicit padding, got {pad!r}")
    n, c, h, w = x.shape
    out_h = _pool_out_size(h, k[0], s[0], pad[0][0], pad[0][1], ceil_mode)
    out_w = _pool_out_size(w, k[1], s[1], pad[1][0], pad[1][1], ceil_mode)
    need_h = (out_h - 1) * s[0] + k[0]
    need_w = (out_w - 1) * s[1] + k[1]
    ph = (pad[0][0], max(pad[0][1], need_h - h - pad[0][0]))
    pw = (pad[1][0], max(pad[1][1], need_w - w - pad[1][0]))
    flat = [pw[0], pw[1], ph[0], ph[1]]
    xp = TF.pad(x, flat, value=-math.inf)
    iota = torch.arange(h * w, dtype=torch.int64,
                        device=x.device).reshape(1, 1, h, w)
    ip = TF.pad(iota, flat, value=-1)
    out, idx = TF.max_pool2d(xp, k, s, 0, return_indices=True)
    out, idx = out[..., :out_h, :out_w], idx[..., :out_h, :out_w]
    mask = ip.reshape(-1)[idx].to(torch.int32)
    return out, mask


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    if return_mask:
        raise NotImplementedError(
            "return_mask is implemented for max_pool2d only; 1d/3d "
            "masks raise loudly rather than silently ignoring the "
            "flag")
    return _max_pool(x, kernel_size, stride, padding, 3,
                     data_format == "NDHWC", ceil_mode)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, kernel_size, stride, padding, 1,
                     data_format == "NLC", exclusive, ceil_mode)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    out = _avg_pool(x, kernel_size, stride, padding, 2,
                    data_format == "NHWC", exclusive, ceil_mode)
    if divisor_override is not None:
        k = _norm_tuple(kernel_size, 2)
        out = out * (float(np.prod(k)) / divisor_override)
    return out


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    out = _avg_pool(x, kernel_size, stride, padding, 3,
                    data_format == "NDHWC", exclusive, ceil_mode)
    if divisor_override is not None:
        k = _norm_tuple(kernel_size, 3)
        out = out * (float(np.prod(k)) / divisor_override)
    return out


def _adaptive(x, output_size, n, channel_last, op):
    axes = (list(range(1, 1 + n)) if channel_last
            else list(range(2, 2 + n)))
    out_size = (output_size,) * n if isinstance(output_size,
                                                (int, np.integer)) \
        else tuple(output_size)
    result = x
    for i, ax in enumerate(axes):
        in_s, out_s = result.shape[ax], out_size[i]
        if out_s is None:
            continue
        out_s = int(out_s)
        if in_s % out_s == 0:
            r = result.reshape(result.shape[:ax] + (out_s, in_s // out_s)
                               + result.shape[ax + 1:])
            result = r.amax(dim=ax + 1) if op == "max" else r.mean(dim=ax + 1)
        else:
            starts = (np.arange(out_s) * in_s) // out_s
            ends = ((np.arange(out_s) + 1) * in_s + out_s - 1) // out_s
            pieces = []
            for s_, e_ in zip(starts, ends):
                seg = result.narrow(ax, int(s_), int(e_ - s_))
                pieces.append(seg.amax(dim=ax, keepdim=True) if op == "max"
                              else seg.mean(dim=ax, keepdim=True))
            result = torch.cat(pieces, dim=ax)
    return result


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive(x, output_size, 1, False, "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive(x, output_size, 2, data_format == "NHWC", "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive(x, output_size, 3, data_format == "NDHWC", "avg")


def _no_mask(return_mask):
    if return_mask:
        raise NotImplementedError(
            "adaptive max-pool masks are not implemented; raising "
            "loudly rather than silently ignoring return_mask")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask)
    return _adaptive(x, output_size, 1, False, "max")


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask)
    return _adaptive(x, output_size, 2, False, "max")


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    _no_mask(return_mask)
    return _adaptive(x, output_size, 3, False, "max")
