"""nn.functional.extension (counterpart of
paddle_tpu/nn/functional/extension.py: diag_embed and friends)."""
from __future__ import annotations

import torch

from ...core.dtypes import convert_dtype
from ...ops.extras import diag_embed, gather_tree  # noqa: F401

__all__ = ["diag_embed", "gather_tree", "sequence_mask"]


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """[B] lengths -> [B, maxlen] 0/1 mask (ref sequence_mask_op.h; the
    port's copy of paddle_tpu/ops/sequence.py's, the one this module
    exports there). maxlen None takes the longest length."""
    if maxlen is None:
        maxlen = int(x.max())
    rng = torch.arange(int(maxlen), dtype=x.dtype, device=x.device)
    return (rng < x[..., None]).to(convert_dtype(dtype))
