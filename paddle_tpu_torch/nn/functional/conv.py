"""Convolution functionals (counterpart of paddle_tpu/nn/functional/conv.py).

The JAX package computes every convolution with XLA's
lax.conv_general_dilated; the port calls torch's F.conv*d and
F.conv_transpose*d (cuDNN on the card): a library convolution, as a
plain matmul is. Each goes through the AMP cast point under the JAX op
name ("conv2d", ...: white-list ops, bf16 under O1).

Padding takes every form the JAX package's _padding takes: an int, n
ints, 2n ints (lo, hi per dim), the full-layout [[0,0],[0,0],[a,b],[c,d]]
form, and "SAME"/"VALID" at any stride (XLA's SAME: out = ceil(in /
stride), the odd pad on the high side). torch pads each dim by one
symmetric amount, so an asymmetric pair is applied with F.pad first.

A transposed convolution is the JAX package's lhs-dilated convolution
with padding (eff_k - 1 - lo, eff_k - 1 - hi + output_padding): torch's
conv_transpose with no padding gives the whole (in - 1) * stride + eff_k
extent, which is cut (or, where output_padding passes the extent,
zero-extended) by F.pad with those amounts negated. Weights keep paddle's
layouts: (out, in/groups, *k), and (in, out/groups, *k) for transposes,
which are torch's too.

data_format NLC/NHWC/NDHWC runs on the channels-first view (a permute in
and out).

The convolution runs through _Conv, whose forward and backward dispatch
aten's convolution ops under torch's deterministic-algorithms flag (as
nn/functional/common.py's _Embedding does its backward): the library
then picks only algorithms that give the same bits every run, so a
captured training step replays its eager body bit for bit (the flag is
read when an op is dispatched, so a CUDA graph keeps those kernels).
DETERMINISTIC = False drops the flag, to price it.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ...amp.auto_cast import amp_cast

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

#: convolutions under torch's deterministic-algorithms flag (module
#: docstring); a measurement may turn it off to price it
DETERMINISTIC = True


class _deterministic:
    """torch's deterministic-algorithms flag on inside (when DETERMINISTIC),
    without its fill of uninitialised memory, both restored after."""

    def __enter__(self):
        self.prev = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled(),
                     torch._C._get_deterministic_fill_uninitialized_memory())
        if DETERMINISTIC:
            # the flag alone (torch.use_deterministic_algorithms also
            # imports inductor's config, seconds at a process's first
            # call); no NaN fill of every empty() the backward makes
            torch._C._set_deterministic_algorithms(True)
            torch._C._set_deterministic_fill_uninitialized_memory(False)

    def __exit__(self, *exc):
        on, warn, fill = self.prev
        torch._C._set_deterministic_algorithms(on, warn_only=warn)
        torch._C._set_deterministic_fill_uninitialized_memory(fill)


class _Conv(torch.autograd.Function):
    """aten.convolution, its backward aten.convolution_backward, both
    dispatched under _deterministic."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, transposed,
                output_padding, groups):
        ctx.save_for_backward(x, weight)
        ctx.args = (stride, padding, dilation, transposed, output_padding,
                    groups)
        ctx.bias_sizes = None if bias is None else list(bias.shape)
        with _deterministic():
            return torch.ops.aten.convolution(
                x, weight, bias, stride, padding, dilation, transposed,
                output_padding, groups)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need = ctx.needs_input_grad
        mask = [need[0], need[1], ctx.bias_sizes is not None and need[2]]
        with _deterministic():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, weight, ctx.bias_sizes, *ctx.args, mask)
        return (gx, gw, gb) + (None,) * 6


def _convolution(x, weight, bias, stride, padding, dilation, groups,
                 transposed=False, output_padding=None):
    n = x.dim() - 2
    return _Conv.apply(x, weight, bias, list(stride), list(padding),
                       list(dilation), transposed,
                       list(output_padding or (0,) * n), groups)


def _norm_tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(i) for i in v)


def _padding(padding, n):
    """paddle padding as the JAX package reads it: "SAME"/"VALID", or
    n (lo, hi) pairs."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (int, np.integer)):
        return [(int(padding), int(padding))] * n
    padding = list(padding)
    if len(padding) == n and all(isinstance(p, (int, np.integer))
                                 for p in padding):
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    # the full-layout form [[0,0],[0,0],[a,b],[c,d]]
    return [tuple(int(i) for i in p) for p in padding[-n:]]


def _same_pads(spatial, k, stride, dilation):
    """XLA's SAME pads (lax.padtype_to_pads): out = ceil(in / stride), the
    total pad split with the odd element on the high side."""
    pads = []
    for size, kk, s, d in zip(spatial, k, stride, dilation):
        eff = d * (kk - 1) + 1
        out = math.ceil(size / s)
        total = max((out - 1) * s + eff - size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _channels_first(x, n, channel_last):
    return x.permute(0, n + 1, *range(1, n + 1)) if channel_last else x


def _channels_back(out, n, channel_last):
    return out.permute(0, *range(2, n + 2), 1) if channel_last else out


def _torch_pad(pairs):
    """(lo, hi) pairs of the spatial dims, outermost first, as F.pad's
    flat list (innermost first)."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    return flat


def _conv(op_name, x, weight, bias, stride, padding, dilation, groups, n,
          channel_last):
    x, weight, bias = amp_cast(op_name, x, weight, bias)
    x = _channels_first(x, n, channel_last)
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    pad = _padding(padding, n)
    if pad == "SAME":
        pad = _same_pads(x.shape[2:], weight.shape[2:], stride, dilation)
    elif pad == "VALID":
        pad = [(0, 0)] * n
    if all(lo == hi for lo, hi in pad):
        sym = tuple(lo for lo, _ in pad)
    else:
        x = TF.pad(x, _torch_pad(pad))
        sym = (0,) * n
    out = _convolution(x, weight, bias, stride, sym, dilation, groups)
    return _channels_back(out, n, channel_last)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv("conv1d", x, weight, bias, stride, padding, dilation,
                 groups, 1, data_format == "NLC")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None, preferred_element_type=None):
    """preferred_element_type ("int32", the JAX package's int8 quantized
    inference) comes with quant's QAT/PTQ (ROADMAP.md item 18)."""
    if preferred_element_type is not None:
        raise NotImplementedError(
            "conv2d(preferred_element_type=...) is the int8 quantized "
            "path of quant's QAT/PTQ, not ported yet (ROADMAP.md item 18)")
    return _conv("conv2d", x, weight, bias, stride, padding, dilation,
                 groups, 2, data_format == "NHWC")


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv("conv3d", x, weight, bias, stride, padding, dilation,
                 groups, 3, data_format == "NDHWC")


def _conv_transpose(op_name, x, weight, bias, stride, padding,
                    output_padding, dilation, groups, n, channel_last,
                    output_size=None):
    x, weight, bias = amp_cast(op_name, x, weight, bias)
    x = _channels_first(x, n, channel_last)
    stride = _norm_tuple(stride, n)
    dilation = _norm_tuple(dilation, n)
    k = weight.shape[2:]
    pad = _padding(padding, n)
    if pad == "SAME":
        pad = [((ks - 1) // 2, ks // 2) for ks in k]
    elif pad == "VALID":
        pad = [(0, 0)] * n
    opad = _norm_tuple(output_padding or 0, n)
    if all(lo == hi for lo, hi in pad) and all(
            o < max(s, d) for o, s, d in zip(opad, stride, dilation)):
        out = _convolution(x, weight, bias, stride,
                           tuple(lo for lo, _ in pad), dilation, groups,
                           True, opad)
    else:
        full = _convolution(x, weight, None, stride, (0,) * n, dilation,
                            groups, True)
        out = TF.pad(full, _torch_pad([(-lo, o - hi) for (lo, hi), o
                                       in zip(pad, opad)]))
        if bias is not None:
            out = out + bias.reshape((1, -1) + (1,) * n)
    if output_size is not None:
        # cut to the requested size where the output is larger
        target = _norm_tuple(output_size, n)
        out = out[(slice(None), slice(None))
                  + tuple(slice(None, t) if out.shape[2 + i] > t
                          else slice(None) for i, t in enumerate(target))]
    return _channels_back(out, n, channel_last)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose("conv1d_transpose", x, weight, bias, stride,
                           padding, output_padding, dilation, groups, 1,
                           data_format == "NLC", output_size)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose("conv2d_transpose", x, weight, bias, stride,
                           padding, output_padding, dilation, groups, 2,
                           data_format == "NHWC", output_size)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose("conv3d_transpose", x, weight, bias, stride,
                           padding, output_padding, dilation, groups, 3,
                           data_format == "NDHWC", output_size)
