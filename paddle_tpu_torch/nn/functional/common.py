"""linear, dropout, embedding (counterpart of
paddle_tpu/nn/functional/common.py)."""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast
from ...core.generator import scope_generator

__all__ = ["linear", "dropout", "embedding"]


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
        was = torch.are_deterministic_algorithms_enabled()
        warn = torch.is_deterministic_algorithms_warn_only_enabled()
        # the flag alone (torch.use_deterministic_algorithms also sets
        # inductor's config, whose import costs a process seconds at its
        # first backward; the port compiles nothing with inductor)
        torch._C._set_deterministic_algorithms(True)
        try:
            gw = torch.ops.aten.embedding_dense_backward(
                g.contiguous(), x, ctx.rows, -1, False)
        finally:
            torch._C._set_deterministic_algorithms(was, warn_only=warn)
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
