"""Loss-scaling primitives on the device (counterpart of
paddle_tpu/amp/functional.py).

The JAX package composes these into its compiled TrainStep so the fp16
step never leaves the device. Here they are torch ops on device tensors:
nothing is read back to the host, so a step that uses them does not
synchronise with the card.
"""
from __future__ import annotations

import torch

__all__ = ["check_finite_and_unscale_tree", "update_loss_scaling_state"]


def check_finite_and_unscale_tree(grads, scale):
    """Unscale the gradient tensors in place (g / scale) and return
    found_inf, a bool device tensor: True when any of them holds a
    non-finite value (check_finite_and_unscale_op.cc semantics)."""
    grads = [g for g in grads if g is not None]
    device = scale.device
    found = torch.zeros((), dtype=torch.float32, device=device)
    inv = (1.0 / scale.to(torch.float32)).reshape(())
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        torch._amp_foreach_non_finite_check_and_unscale_(group, found, inv)
    return found > 0


def update_loss_scaling_state(scale, good, bad, found_inf, incr_ratio=2.0,
                              decr_ratio=0.5, incr_every_n=1000,
                              decr_every_n=1):
    """update_loss_scaling op, on device tensors: returns (scale,
    good_steps, bad_steps). On overflow the scale decays (floored at
    1.0); after incr_every_n clean steps it grows."""
    good = torch.where(found_inf, torch.zeros_like(good), good + 1)
    bad = torch.where(found_inf, bad + 1, torch.zeros_like(bad))
    hit_bad = bad >= decr_every_n
    scale = torch.where(hit_bad, torch.clamp(scale * decr_ratio, min=1.0),
                        scale)
    bad = torch.where(hit_bad, torch.zeros_like(bad), bad)
    hit_good = good >= incr_every_n
    scale = torch.where(hit_good, scale * incr_ratio, scale)
    good = torch.where(hit_good, torch.zeros_like(good), good)
    return scale, good, bad
