"""Gradient clipping (counterpart of paddle_tpu/nn/clip.py).

ClipGradBy{Value,Norm,GlobalNorm} map a list of (param, grad) pairs to a
new list, as the JAX package's do; the eager Optimizer.step applies an
optimizer's grad_clip before its rule (optimizer/optimizer.py).
clip_grad_norm_ and clip_grad_value_ clip the params' .grad in place.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each gradient element clamped to [min, max] (min defaults to
    -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g if g is None else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by min(clip_norm / ||g||, 1), its own L2
    norm."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g)))
            scale = torch.clamp(
                self.clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by min(clip_norm / ||all grads||, 1), the
    global L2 norm summed in f32; a param whose need_clip is False keeps
    its gradient. On the device throughout: no value is read back."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for _, g in params_grads if g is not None]
        if not grads:
            return params_grads
        sq = torch._foreach_norm([g.float() for g in grads])
        gnorm = torch.linalg.vector_norm(torch.stack(sq))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        return [(p, g) if g is None or not getattr(p, "need_clip", True)
                else (p, (g * scale).to(g.dtype))
                for p, g in params_grads]


def _params(parameters):
    return [parameters] if isinstance(parameters, torch.Tensor) \
        else list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the params' .grad in place to a total norm of at most
    max_norm (norm_type p, or inf); returns the total norm."""
    grads = [p.grad for p in _params(parameters) if p.grad is not None]
    if not grads:
        return torch.tensor(0.0)
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = sum(torch.sum(g.float().abs() ** norm_type)
                    for g in grads) ** (1.0 / norm_type)
    scale = torch.clamp(max_norm / torch.clamp(total, min=1e-12), max=1.0)
    for g in grads:
        g.copy_((g * scale).to(g.dtype))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp the params' .grad in place to [-clip_value, clip_value]."""
    for p in _params(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
