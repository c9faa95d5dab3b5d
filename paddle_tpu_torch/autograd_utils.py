"""paddle.grad: gradients of outputs with respect to chosen inputs
(counterpart of paddle_tpu/autograd_utils.py).

The JAX package sweeps its tape (create_graph=False) or replays the
contributing subgraph under jax.vjp inside a taped op (create_graph=True,
so the gradients can be differentiated again). Here both are
torch.autograd.grad: create_graph keeps the gradient's own graph.
no_grad_vars are tensors the gradient must not flow through: a hook on
each replaces the gradient that reaches it with zeros, as the JAX
sweep skips their nodes.
"""
from __future__ import annotations

import torch

__all__ = ["partial_grad"]


def _listed(x):
    if x is None:
        return None
    return [x] if isinstance(x, torch.Tensor) else list(x)


def _zero(g):
    return torch.zeros_like(g)


def partial_grad(outputs, inputs, grad_outputs=None, retain_graph=None,
                 create_graph=False, allow_unused=False, no_grad_vars=None):
    """The gradients of sum(outputs * grad_outputs) with respect to each
    of `inputs` (a list; a tensor gives a one-element list); a missing
    grad_output is ones, as the JAX sweep seeds it. An input the
    outputs do not reach gets None with allow_unused, else zeros (the JAX
    package's sweep)."""
    outputs = _listed(outputs)
    inputs = _listed(inputs)
    grad_outputs = _listed(grad_outputs) or [None] * len(outputs)
    grad_outputs = [torch.ones_like(o) if g is None else g
                    for o, g in zip(outputs, grad_outputs)]
    if retain_graph is None:
        retain_graph = create_graph
    hooks = [v.register_hook(_zero) for v in (_listed(no_grad_vars) or [])
             if isinstance(v, torch.Tensor) and v.requires_grad]
    try:
        grads = list(torch.autograd.grad(
            outputs, inputs, grad_outputs, retain_graph=retain_graph,
            create_graph=create_graph, allow_unused=True))
    finally:
        for h in hooks:
            h.remove()
    if allow_unused:
        return grads
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(inputs, grads)]
