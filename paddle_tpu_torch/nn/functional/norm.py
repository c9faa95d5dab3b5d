"""Normalization functionals (counterpart of
paddle_tpu/nn/functional/norm.py).

batch_norm follows the JAX package's _bn_full: in training it normalises
with the BIASED batch variance and updates the running statistics,
in place, with paddle's momentum,

    running = momentum * running + (1 - momentum) * batch

and the biased variance in the running variance too. torch's
F.batch_norm(training=True) would update with the opposite momentum and
the unbiased variance, so it does not own the buffers here: the output
comes from torch._batch_norm_impl_index with no running statistics (the
op F.batch_norm dispatches through: cuDNN's batch norm on the card,
aten's on the CPU), which also returns the batch mean and 1/sqrt(var +
eps), and the buffers are written from those under no_grad. It is an
AMP black-list op ("batch_norm_op"): float32 under O1, as in the JAX
package.

Two scopes, both thread-local, change what a training batch_norm does:

- batch_stat_scope(groups): the batch moments are averaged over those
  process groups (the data axes of DataParallel and of TrainStep over a
  mesh, where each rank holds a block of the global batch), so the
  function is the JAX step's on the global batch. The mean is reduced
  first, then the mean square deviation from it; each all-reduce AVG is
  an autograd Function whose backward is the same AVG of the
  cotangents. SyncBatchNorm reduces over the same groups.
- frozen_running_stats(): the running statistics are not written. A
  recompute (distributed/recompute.py) re-runs the forward in the
  backward; jax.checkpoint recomputes without a second buffer update,
  and under this scope so does the port.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import amp_cast
from ...core.recordable import recordable

__all__ = ["batch_norm", "layer_norm", "group_norm", "instance_norm",
           "local_response_norm", "normalize"]

_state = threading.local()


def _channel_axis(ndim, data_format):
    return ndim - 1 if data_format[-1] == "C" else 1


@contextlib.contextmanager
def batch_stat_scope(groups):
    """Inside, a training batch_norm averages its batch moments over the
    process groups `groups` (a list; empty or None: local moments)."""
    prev = getattr(_state, "groups", None)
    _state.groups = list(groups) if groups else None
    try:
        yield
    finally:
        _state.groups = prev


def stat_groups():
    """The groups of the innermost batch_stat_scope, or None."""
    return getattr(_state, "groups", None)


@contextlib.contextmanager
def frozen_running_stats():
    """Inside, batch_norm computes as usual but writes no running
    statistic (a recompute's second forward)."""
    prev = getattr(_state, "frozen", False)
    _state.frozen = True
    try:
        yield
    finally:
        _state.frozen = prev


class _AvgOver(torch.autograd.Function):
    """An all-reduce AVG over a process group whose backward is the AVG
    of the cotangents: each rank's moment feeds every rank's output, and
    the step averages the gradients over the same ranks after."""

    @staticmethod
    def forward(ctx, t, pg):
        from ...distributed import collective as _c
        ctx.pg = pg
        out = t.clone()
        _c._all_reduce_(out, _c.ReduceOp.AVG, pg)
        return out

    @staticmethod
    def backward(ctx, g):
        from ...distributed import collective as _c
        g = g.clone()
        _c._all_reduce_(g, _c.ReduceOp.AVG, ctx.pg)
        return g, None


def _avg_over(t, groups):
    for pg in groups:
        t = _AvgOver.apply(t, pg)
    return t


def _synced_moments(x, ch_axis, groups):
    """(mean, biased var) per channel of x, averaged over `groups`
    (equal blocks of one global batch on each rank): the global batch's
    moments, differentiable."""
    dims = tuple(i for i in range(x.dim()) if i != ch_axis)
    shape = [1] * x.dim()
    shape[ch_axis] = x.shape[ch_axis]
    mean = _avg_over(x.mean(dim=dims), groups)
    d = x - mean.reshape(shape)
    var = _avg_over((d * d).mean(dim=dims), groups)
    return mean, var


@torch.no_grad()
def _update_running(running_mean, running_var, mean, var, momentum):
    """The paddle update, in place, unless frozen_running_stats is on."""
    if getattr(_state, "frozen", False):
        return
    running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
    running_var.copy_(momentum * running_var + (1 - momentum) * var)


def _normalize_with(x, mean, var, weight, bias, epsilon, ch_axis):
    """(x - mean) * rsqrt(var + eps) * weight + bias, per channel."""
    shape = [1] * x.dim()
    shape[ch_axis] = x.shape[ch_axis]
    out = (x - mean.reshape(shape)) * torch.rsqrt(var + epsilon).reshape(
        shape)
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


@recordable
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """Batch norm over every dim but the channel's. In training (and
    use_global_stats off) it normalises with the batch's moments and
    updates running_mean/running_var in place; otherwise it normalises
    with them."""
    ch_axis = _channel_axis(x.dim(), data_format)
    if use_global_stats is None:
        use_global_stats = not training
    train_mode = training and not use_global_stats
    x, weight, bias = amp_cast("batch_norm_op", x, weight, bias)
    groups = stat_groups() if train_mode else None
    if groups:
        mean, var = _synced_moments(x, ch_axis, groups)
        _update_running(running_mean, running_var, mean.detach(),
                       var.detach(), momentum)
        return _normalize_with(x, mean, var, weight, bias, epsilon, ch_axis)
    xc = x.movedim(ch_axis, 1) if ch_axis != 1 else x
    if not train_mode:
        out = TF.batch_norm(xc, running_mean.to(xc.dtype),
                            running_var.to(xc.dtype), weight, bias, False,
                            0.0, epsilon)
    else:
        # (out, batch mean, 1/sqrt(var + eps), reserve, which library);
        # the last argument lets it take the card's library kernels
        out, mean, invstd, _, _ = torch._batch_norm_impl_index(
            xc, weight, bias, None, None, True, 0.0, epsilon, True)
        with torch.no_grad():
            # the biased batch variance, from 1/sqrt(var + eps)
            var = invstd.pow(-2) - epsilon
        _update_running(running_mean, running_var, mean, var, momentum)
    return out.movedim(1, ch_axis) if ch_axis != 1 else out


def layer_norm(x, normalized_shape=None, weight=None, bias=None,
               epsilon=1e-05, name=None):
    """(x - mean) / sqrt(var + eps) * weight + bias over the trailing
    `normalized_shape` dims, with the biased variance, as the JAX
    package computes it. An AMP black-list op ("layer_norm_op"): float32
    in and out under auto_cast."""
    if normalized_shape is None:
        normalized_shape = (x.shape[-1],)
    elif isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = amp_cast("layer_norm_op", x, weight, bias)
    return TF.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)


def group_norm(x, num_groups, epsilon=1e-05, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Normalises each group of C/num_groups channels over them and the
    spatial dims (biased variance). Black-list op ("group_norm_op")."""
    ch_axis = _channel_axis(x.dim(), data_format)
    x, weight, bias = amp_cast("group_norm_op", x, weight, bias)
    xc = x.movedim(ch_axis, 1) if ch_axis != 1 else x
    out = TF.group_norm(xc, num_groups, weight, bias, epsilon)
    return out.movedim(1, ch_axis) if ch_axis != 1 else out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-05,
                  data_format="NCHW", name=None):
    """Each (sample, channel) normalised over its spatial dims, always
    with the input's statistics (the JAX package reads no running stat).
    Black-list op ("instance_norm_op")."""
    ch_axis = _channel_axis(x.dim(), data_format)
    x, weight, bias = amp_cast("instance_norm_op", x, weight, bias)
    xc = x.movedim(ch_axis, 1) if ch_axis != 1 else x
    out = TF.instance_norm(xc, None, None, weight, bias, True, 0.0, eps)
    return out.movedim(1, ch_axis) if ch_axis != 1 else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * sum(x^2 over `size` channels) / size) ** beta,
    the window padded (size // 2, size - size // 2 - 1)."""
    ch_axis = _channel_axis(x.dim(), data_format)
    xc = x.movedim(ch_axis, 1) if ch_axis != 1 else x
    sq = (xc * xc).movedim(1, -1)
    half = size // 2
    summed = TF.pad(sq, (half, size - half - 1)).unfold(-1, size, 1).sum(-1)
    div = torch.pow(k + alpha * summed.movedim(-1, 1) / size, beta)
    out = xc / div
    return out.movedim(1, ch_axis) if ch_axis != 1 else out


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """x / max(||x||_p along axis, epsilon)."""
    if p == 2:
        denom = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True))
    else:
        denom = torch.pow(torch.sum(torch.abs(x) ** p, dim=axis,
                                    keepdim=True), 1.0 / p)
    return x / torch.clamp(denom, min=epsilon)
