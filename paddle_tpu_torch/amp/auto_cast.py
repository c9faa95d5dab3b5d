"""AMP autocast (counterpart of paddle_tpu/amp/auto_cast.py).

The same O1/O2 white and black lists, keyed by the JAX package's op
names. The JAX package casts in its op registry's dispatch hook; the port
has no registry, so each functional that has an op name calls
amp_cast(op_name, *tensors) itself, which reads the thread-local state
that auto_cast sets:

- O1: white-list ops cast floating inputs to the AMP dtype (bf16), black
  -list ops to float32, others run in the dtype they get;
- O2: every op casts to the AMP dtype except the black list (float32).

torch.autocast is not used: its op lists differ (it would up-cast
cross_entropy's logits, which the JAX package keeps low on purpose) and
it does not see the ctypes kernels. Casts are tensor.to(), so gradients
flow back through them in the source dtype.
"""
from __future__ import annotations

import threading
from typing import Set

import torch

from ..core import dtypes as _dtypes

__all__ = ["auto_cast", "amp_guard", "amp_cast", "amp_state",
           "amp_state_scope", "white_list", "black_list", "AMP_WHITE_LIST",
           "AMP_BLACK_LIST"]

# mirror of fp16_lists.py: ops that are numerically safe in low precision
AMP_WHITE_LIST: Set[str] = {
    "matmul_v2", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "linear", "bmm", "mv", "addmm",
    "flash_attention_op", "scaled_dot_product_attention",
    "sdpa_dropout", "flash_attention_dropout", "einsum",
    "lstm_cell", "gru_cell", "simple_rnn_cell", "rnn_scan",
}

# ops that must stay in fp32 (reductions / norms / losses / exp-family).
# cross_entropy is deliberately NOT listed: its hard-label path keeps the
# [N, vocab] logits in their storage dtype and accumulates in f32
# internally (nn/functional/loss.py), so bf16 logits stay bf16.
AMP_BLACK_LIST: Set[str] = {
    "softmax_op", "log_softmax_op",
    "softmax_with_cross_entropy_op", "bce_loss", "bce_with_logits",
    "layer_norm_op", "batch_norm_op", "group_norm_op",
    "instance_norm_op", "sync_batch_norm", "reduce_sum", "reduce_mean",
    "p_norm", "logsumexp", "exp", "log", "log2", "log10", "log1p", "pow",
    "elementwise_pow", "square", "sqrt", "rsqrt", "reciprocal", "cumsum",
    "reduce_prod", "softplus", "mse_loss_op", "l1_loss_op", "kldiv_loss_op",
    "nll_loss_op", "ctc_loss_op",
}

white_list = AMP_WHITE_LIST
black_list = AMP_BLACK_LIST

_state = threading.local()


def amp_state():
    """(level, dtype) inside an enabled auto_cast, else None."""
    level = getattr(_state, "level", None)
    if level is None:
        return None
    return level, _state.dtype


class amp_state_scope:
    """with amp_state_scope(st): the AMP state is exactly `st` inside (an
    amp_state() value; None turns AMP off), restored after. A recompute
    in the backward (distributed/recompute.py) re-enters the state its
    forward ran under."""

    def __init__(self, st):
        self.st = st

    def __enter__(self):
        self.prev = (getattr(_state, "level", None),
                     getattr(_state, "dtype", None))
        _state.level, _state.dtype = self.st if self.st else (None, None)
        return self

    def __exit__(self, *exc):
        _state.level, _state.dtype = self.prev


def _cast(t, to):
    if isinstance(t, torch.Tensor) and t.is_floating_point() \
            and t.dtype != to:
        return t.to(to)
    return t


def amp_cast(op_name: str, *tensors):
    """The inputs of op `op_name` cast as the JAX package's AMP hook
    casts them (tensors pass through outside auto_cast). Returns a tuple
    of the same length; None and non-tensors pass through."""
    st = amp_state()
    if st is None:
        return tensors
    level, dtype = st
    if level == "O2":
        to = torch.float32 if op_name in AMP_BLACK_LIST else dtype
    elif op_name in AMP_WHITE_LIST:
        to = dtype
    elif op_name in AMP_BLACK_LIST:
        to = torch.float32
    else:
        return tensors
    return tuple(_cast(t, to) for t in tensors)


class auto_cast:
    """with paddle_tpu_torch.amp.auto_cast(): ... — O1 (mixed) or O2
    (pure low precision)."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="bfloat16"):
        if level not in ("O0", "O1", "O2"):
            raise ValueError(f"AMP level must be O0, O1 or O2, got {level!r}")
        self.enable = enable and level != "O0"
        self.level = level
        self.dtype = _dtypes.convert_dtype(dtype)
        if self.dtype not in (torch.bfloat16, torch.float16):
            raise ValueError(f"AMP dtype must be bfloat16 or float16, got "
                             f"{dtype!r}")
        self.extra_white = set(custom_white_list or ())
        self.extra_black = set(custom_black_list or ())

    def __enter__(self):
        self.prev = (getattr(_state, "level", None),
                     getattr(_state, "dtype", None))
        if self.enable:
            _state.level = self.level
            _state.dtype = self.dtype
            AMP_WHITE_LIST.update(self.extra_white)
            AMP_BLACK_LIST.update(self.extra_black)
        return self

    def __exit__(self, *exc):
        _state.level, _state.dtype = self.prev
        if self.enable:
            AMP_WHITE_LIST.difference_update(self.extra_white)
            AMP_BLACK_LIST.difference_update(self.extra_black)


amp_guard = auto_cast
