"""Hard-label softmax cross-entropy (counterpart of
paddle_tpu/nn/functional/loss.py: cross_entropy and
softmax_with_cross_entropy on their hard-label, last-axis path).

The JAX package's `_softmax_ce_fused` custom VJP keeps the [N, vocab]
logits in their storage dtype end to end: reductions run in f32 inside
XLA fusions and dlogits comes out in the logits dtype, so under AMP O1
no f32 copy of the largest tensor of a pretraining step is ever written.
PyTorch runs eagerly and cannot fuse, so the port's torch.autograd
Function walks the rows in chunks: each chunk is widened to f32, reduced
and dropped, and the backward writes each chunk of dlogits in the logits
dtype. The f32 temporaries are one chunk (at most 2^26 elements, 256 MB),
never the whole [b*s, 30528] tensor.
"""
from __future__ import annotations

import torch

__all__ = ["cross_entropy", "softmax_with_cross_entropy"]

_CHUNK_ELEMS = 1 << 26


def _row_chunks(n_rows, n_cols):
    step = max(1, _CHUNK_ELEMS // max(n_cols, 1))
    return [(r, min(r + step, n_rows)) for r in range(0, n_rows, step)]


def _acc(t):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


class _SoftmaxCE(torch.autograd.Function):
    """Per-row loss lse(logits) - logits[label] (0 where not valid) of
    logits [N, C], labels int [N] (pre-clamped to range), valid bool
    [N]; the loss is f32 (f64 for f64 logits)."""

    @staticmethod
    def forward(ctx, logits, labels, valid):
        acc = _acc(logits)
        lse = torch.empty(logits.shape[0], dtype=acc, device=logits.device)
        for r0, r1 in _row_chunks(*logits.shape):
            x = logits[r0:r1].to(acc)
            m = x.amax(dim=-1)
            lse[r0:r1] = m + torch.log(torch.exp(x - m[:, None]).sum(-1))
        picked = logits.gather(1, labels[:, None])[:, 0].to(acc)
        loss = torch.where(valid, lse - picked, 0.0)
        ctx.save_for_backward(logits, labels, valid, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, valid, lse = ctx.saved_tensors
        acc = lse.dtype
        gm = torch.where(valid, g.to(acc), 0.0)
        d = torch.empty_like(logits)
        cols = torch.arange(logits.shape[1], device=logits.device)
        for r0, r1 in _row_chunks(*logits.shape):
            p = torch.exp(logits[r0:r1].to(acc) - lse[r0:r1, None])
            # (softmax - onehot) in f32 BEFORE the storage-dtype cast, as
            # the JAX package does: at the label column p ~ 1
            onehot = cols[None, :] == labels[r0:r1, None]
            d[r0:r1] = ((p - onehot.to(acc)) * gm[r0:r1, None]).to(d.dtype)
        return d, None, None


def _fused_hard_label_ce(logits, label, ignore_index):
    """(per-element loss, valid mask), shaped like the squeezed labels."""
    lbl = label
    if lbl.dim() == logits.dim() and lbl.shape[-1] == 1:
        lbl = lbl.squeeze(-1)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl)).to(torch.int64)
    flat = logits.reshape(-1, logits.shape[-1])
    loss = _SoftmaxCE.apply(flat, safe.reshape(-1), valid.reshape(-1))
    return loss.reshape(lbl.shape), valid


def _check_hard_label(label, soft_label, axis, ndim, what):
    if soft_label or label.is_floating_point():
        raise NotImplementedError(
            f"{what}: soft labels are not ported yet (hard labels only)")
    if axis % ndim != ndim - 1:
        raise NotImplementedError(f"{what}: only the last axis is ported")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False, name=None):
    """Per-row loss with a trailing 1 dim, as Paddle returns it."""
    _check_hard_label(label, soft_label, axis, logits.dim(),
                      "softmax_with_cross_entropy")
    if return_softmax:
        raise NotImplementedError(
            "softmax_with_cross_entropy(return_softmax=True) is not ported")
    loss, _ = _fused_hard_label_ce(logits, label, ignore_index)
    return loss[..., None]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Hard-label softmax cross-entropy over the last axis; "mean"
    averages over the rows whose label is not ignore_index. bf16 logits
    stay bf16 (cross_entropy is on neither AMP list)."""
    _check_hard_label(label, soft_label, axis, input.dim(), "cross_entropy")
    if weight is not None or label_smoothing or not use_softmax:
        raise NotImplementedError(
            "cross_entropy: weight, label_smoothing and use_softmax=False "
            "are not ported yet")
    loss, valid = _fused_hard_label_ce(input, label, ignore_index)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum().to(loss.dtype), min=1.0)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be mean, sum or none, got "
                     f"{reduction!r}")
