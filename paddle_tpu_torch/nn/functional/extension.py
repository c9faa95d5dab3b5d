"""nn.functional.extension (counterpart of
paddle_tpu/nn/functional/extension.py: diag_embed and friends).
sequence_mask is ops/sequence.py's, the one the top level exports, as
the JAX package's extension module exports paddle_tpu/ops/sequence.py's."""
from __future__ import annotations

from ...ops.extras import diag_embed, gather_tree  # noqa: F401
from ...ops.sequence import sequence_mask  # noqa: F401

__all__ = ["diag_embed", "gather_tree", "sequence_mask"]
