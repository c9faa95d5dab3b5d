"""ScannedStack: L structurally identical blocks as one stack of
parameters (counterpart of paddle_tpu/nn/layer/scanned.py).

The JAX package stacks each block parameter to [L, *shape] and runs one
block body under lax.scan, so compile time and program size stay O(1) in
depth. PyTorch runs eagerly and compiles nothing, so there is no such
gain here: the point is the reference's parameter layout and names.
Each stack is named "stk__" + the block path with "." turned into "__"
(`stk__attention__qkv__weight`), so a scanned model's state_dict keys
and shapes equal the JAX scanned model's and load by name
(models/convert.py).

forward runs one template block L times, layer i on slice i of every
stack (torch.func.functional_call); the slices are views of the stacks,
so gradients reach the stacked parameters. The template is called in
layer order, so every random draw (hidden dropout, the attention
kernels' Philox seeds) comes in the order of the unrolled stack: a
scanned model and its unrolled twin with equal weights give equal
results bit for bit, dropout on or off.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import Layer

__all__ = ["ScannedStack"]


def _mangle(name):
    return "stk__" + name.replace(".", "__")


class ScannedStack(Layer):
    def __init__(self, layers, op_name: str = "scanned_stack"):
        """`layers`: constructed, structurally identical blocks whose
        forward is `block(x, *extra)`, x the carried tensor and `extra`
        per-call side inputs shared by every layer."""
        layers = list(layers)
        if not layers:
            raise ValueError("ScannedStack needs at least one block")
        tmpl = layers[0]
        super().__init__(device=next(tmpl.parameters()).device)
        buffers = [k for k, _ in tmpl.named_buffers()]
        if buffers:
            # the stack carries parameters only: a buffer-carrying block
            # (BatchNorm running stats) would train fine but serve
            # whatever one block's buffers hold, so refuse it
            raise ValueError(
                f"ScannedStack blocks must be buffer-free; template "
                f"carries {buffers}: use the unrolled form, or normalize "
                "with buffer-less layers like LayerNorm")
        self.L = len(layers)
        self._op_name = op_name
        # the template runs every layer; deliberately NOT a registered
        # submodule (its own values never train: the stacks are the real
        # parameters, and its storage moves to meta below)
        object.__setattr__(self, "_template", tmpl)
        self._names = [n for n, _ in tmpl.named_parameters()]
        self._mangled = {n: _mangle(n) for n in self._names}
        with torch.no_grad():
            for n in self._names:
                per = [dict(lyr.named_parameters())[n] for lyr in layers]
                p = nn.Parameter(torch.stack([t.detach() for t in per]),
                                 requires_grad=per[0].requires_grad)
                self.register_parameter(self._mangled[n], p)
        # functional_call replaces every template parameter on each call,
        # so its own values are never read: keep no storage for them
        tmpl.to_empty(device="meta")

    def stacked(self, name):
        """The [L, ...] stack of the block parameter `name`."""
        return getattr(self, self._mangled[name])

    @torch.no_grad()
    def load_from_layers(self, layer_list):
        """Import an unrolled stack's weights (an iterable of L
        blocks)."""
        layer_list = list(layer_list)
        if len(layer_list) != self.L:
            raise ValueError(f"{len(layer_list)} blocks for a stack of "
                             f"{self.L}")
        for n in self._names:
            self.stacked(n).copy_(torch.stack(
                [dict(lyr.named_parameters())[n] for lyr in layer_list]))

    @torch.no_grad()
    def export_to_layers(self, layer_list):
        """Write the stacks back into an unrolled stack's blocks (the
        inverse of load_from_layers)."""
        layer_list = list(layer_list)
        if len(layer_list) != self.L:
            raise ValueError(f"{len(layer_list)} blocks for a stack of "
                             f"{self.L}")
        for n in self._names:
            stack = self.stacked(n)
            for i, lyr in enumerate(layer_list):
                dict(lyr.named_parameters())[n].copy_(stack[i])

    def forward(self, x, *extra):
        tmpl = self._template
        tmpl.train(self.training)
        # trailing Nones drop, so the template's own defaults apply
        extra = list(extra)
        while extra and extra[-1] is None:
            extra.pop()
        # per-layer views of the stacks: one unbind each, so the backward
        # stacks the per-layer gradients once
        per = {n: self.stacked(n).unbind(0) for n in self._names}
        for i in range(self.L):
            x = torch.func.functional_call(
                tmpl, {n: per[n][i] for n in self._names}, (x, *extra))
        return x

    def extra_repr(self):
        return f"L={self.L}, op_name={self._op_name!r}"
