"""AMP graph ops (counterpart of paddle_tpu/ops/amp_ops.py):
check_finite_and_unscale and update_loss_scaling over the port's own
loss-scaling primitives (amp/functional.py), on device tensors, with no
read back to the host."""
from __future__ import annotations

import torch

from ..amp.functional import (check_finite_and_unscale_tree,
                              update_loss_scaling_state)
from ._args import tensor_of

__all__ = ["check_finite_and_unscale", "update_loss_scaling"]


def check_finite_and_unscale(*xs, scale=None):
    """Unscale xs by 1/scale; the last output is the found_infinite flag.

    Returns (x0/scale, ..., xn/scale, found_inf), new tensors (the inputs
    are not written). As in the JAX op, the outputs are the unscaled
    values even when found_inf is set: callers gate the update on it."""
    if scale is None:
        raise ValueError("check_finite_and_unscale requires scale=")
    outs = [tensor_of(x).detach().clone() for x in xs]
    scale = tensor_of(scale, outs[0] if outs else None)
    found = check_finite_and_unscale_tree(outs, scale)
    return tuple(outs) + (found,)


def update_loss_scaling(found_inf, prev_loss_scaling, in_good_steps,
                        in_bad_steps, incr_ratio=2.0, decr_ratio=0.5,
                        incr_every_n_steps=1000,
                        decr_every_n_nan_or_inf=1, stop_update=False):
    """Dynamic loss-scale update (update_loss_scaling_op.cc contract).
    Returns (loss_scaling f32, good_steps int32, bad_steps int32)."""
    found = tensor_of(found_inf).to(torch.bool)
    scale = tensor_of(prev_loss_scaling, found).to(torch.float32)
    good = tensor_of(in_good_steps, found).to(torch.int32)
    bad = tensor_of(in_bad_steps, found).to(torch.int32)
    if stop_update:
        return scale, good, bad
    return update_loss_scaling_state(
        scale, good, bad, found, incr_ratio=incr_ratio,
        decr_ratio=decr_ratio, incr_every_n=incr_every_n_steps,
        decr_every_n=decr_every_n_nan_or_inf)
