"""einsum (counterpart of paddle_tpu/ops/einsum.py): torch.einsum, an
AMP white-list op as the JAX package registers it."""
from __future__ import annotations

import torch

from ..amp.auto_cast import amp_cast
from ._args import tensor_of

__all__ = ["einsum"]


def einsum(equation, *operands):
    return torch.einsum(equation, *amp_cast(
        "einsum", *(tensor_of(o) for o in operands)))
