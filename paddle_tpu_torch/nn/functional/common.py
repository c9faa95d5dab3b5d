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


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Row gather; rows of `padding_idx` read as zeros (Paddle's
    lookup_table_v2 semantics). Its backward is torch's dense embedding
    backward (a sum of rows per index), not an index_put over the whole
    table."""
    out = torch.nn.functional.embedding(x, weight)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((x == padding_idx).unsqueeze(-1), 0.0)
    return out
