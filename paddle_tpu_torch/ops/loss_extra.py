"""The port's copy of paddle_tpu/ops/loss_extra.py's
hierarchical_sigmoid (the one function nn.functional.hsigmoid_loss
reaches; the rest of that module is ROADMAP.md item 18.1's)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["hierarchical_sigmoid"]


def hierarchical_sigmoid(x, label, w, bias=None, num_classes=2, name=None):
    """Default-tree hsigmoid (hierarchical_sigmoid_op.h + SimpleCode in
    math/matrix_bit_code.h: c = label + num_classes, node index at bit b
    is (c >> (b + 1)) - 1, target bit is c & (1 << b), path length =
    highest_set_bit(c) - 1). Returns (cost [B, 1], pre_out [B, L]).

    The path length, floor(log2(c)), is counted in integers (the bits
    above the lowest that c has), which equals the JAX package's float
    log2 for every c below 2^24."""
    n = int(num_classes)
    b = x.shape[0]
    max_len = int(np.floor(np.log2(2 * n - 1)))
    c = label.reshape(b).long() + n
    bits = torch.arange(max_len, device=x.device)
    length = sum(((c >> k) > 1).long() for k in range(max_len + 1))
    valid = bits[None, :] < length[:, None]
    idx = ((c[:, None] >> (bits[None, :] + 1)) - 1).clamp(0, w.shape[0] - 1)
    bit = ((c[:, None] >> bits[None, :]) & 1).to(x.dtype)
    pre = torch.einsum("bd,bld->bl", x, w[idx])
    if bias is not None:
        pre = pre + bias.reshape(-1)[idx]
    # BCE-with-logits against the path bits, masked to the path length
    sp = torch.clamp(pre, min=0.0) + torch.log1p(torch.exp(-pre.abs()))
    loss = (sp - bit * pre) * valid.to(x.dtype)
    return loss.sum(1, keepdim=True), pre
