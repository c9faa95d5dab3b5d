"""Philox4x32-10 in torch integer ops: the attention-dropout mask.

Counterpart of `_drop_mask` in paddle_tpu/ops/pallas_kernels.py. The
Pallas mask draws the TPU's own random bits per (seed, q-block, k-block),
so it depends on the TPU block sizes. The port's mask is a pure function
of (seed, b*n + head, row, col), so every kernel, whatever tiles it
uses, and every plain version draw identical bits:

- counter = (col >> 1, row >> 1, bh, 0), key = (seed_lo, seed_hi);
- the element's word is (row & 1) * 2 + (col & 1) of the four output
  words, so one Philox call covers a 2x2 block of (row, col);
- keep when word >= min(floor(p * 2^32), 2^32 - 1), the threshold of
  pallas_kernels.py:170.

paddle_tpu_torch/csrc/philox.cuh is the same generator on the card; the
forward kernel and both backward kernels call it. Here uint32 arithmetic
runs in int64 with `& 0xffffffff`, and the 32x32-bit products are split
into 16-bit halves so no intermediate leaves int64's positive range.
Random123's known answers hold (tests/test_torch_philox.py).
"""
from __future__ import annotations

import torch

from ..core.generator import seed_int64

__all__ = ["philox4x32", "drop_threshold", "keep_mask", "split_seed",
           "seed_int64"]

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the constant a times the uint32s in b."""
    p1 = (a & 0xFFFF) * b              # < 2^48
    p2 = (a >> 16) * b                 # < 2^48
    lo_full = p1 + ((p2 & 0xFFFF) << 16)
    return (lo_full >> 32) + (p2 >> 16), lo_full & _MASK


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of broadcastable int64 counters holding uint32
    values and a 64-bit key given as two uint32 values (ints or 0-d
    int64 tensors). Returns the four output words as int64 tensors."""
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def drop_threshold(p: float) -> int:
    """The uint32 threshold: keep a link when its word is >= this."""
    return min(int(float(p) * 4294967296.0), 4294967295)


def split_seed(seed):
    """A 64-bit seed as the Philox key (lo, hi): ints for an int seed,
    int64 tensors for a seed held in a 0-d int64 tensor (read on the
    device, no host sync)."""
    if isinstance(seed, torch.Tensor):
        if seed.dtype != torch.int64 or seed.numel() != 1:
            raise TypeError(f"a seed tensor is one int64, got "
                            f"{seed.dtype} of shape {tuple(seed.shape)}")
        seed = seed.reshape(())
        return seed & _MASK, (seed >> 32) & _MASK
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & _MASK, seed >> 32


def keep_mask(seed, p: float, bh, rows, cols):
    """Boolean keep-mask of attention dropout.

    seed: an int, or a 0-d int64 tensor on the device of rows (the form
    the kernels take). bh, rows, cols: broadcastable integer tensors of
    (batch*heads + head, query row, key column). Returns a bool tensor
    of their broadcast shape: True where the link is kept (probability
    1 - p)."""
    k0, k1 = split_seed(seed)
    bh, rows, cols = (t.to(torch.int64) for t in (bh, rows, cols))
    zero = torch.zeros((), dtype=torch.int64, device=rows.device)
    w = philox4x32(cols >> 1, rows >> 1, bh, zero, k0, k1)
    sel = (rows & 1) * 2 + (cols & 1)
    word = torch.where(sel == 0, w[0], torch.where(
        sel == 1, w[1], torch.where(sel == 2, w[2], w[3])))
    return word >= drop_threshold(p)
