"""Softmax cross-entropy and the vocab-chunked projection + CE
(counterpart of paddle_tpu/nn/functional/loss.py: cross_entropy,
softmax_with_cross_entropy and linear_cross_entropy).

Hard labels over the last axis take the fused path. The JAX package's
`_softmax_ce_fused` custom VJP keeps the [N, vocab] logits in their
storage dtype end to end: reductions run in f32 inside XLA fusions and
dlogits comes out in the logits dtype, so under AMP O1 no f32 copy of
the largest tensor of a pretraining step is ever written. PyTorch runs
eagerly and cannot fuse, so the port's torch.autograd Function walks the
rows in chunks: each chunk is widened to f32, reduced and dropped, and
the backward writes each chunk of dlogits in the logits dtype. The f32
temporaries are one chunk (at most 2^26 elements, 256 MB), never the
whole [b*s, 30528] tensor.

Soft labels, class weights, label smoothing, use_softmax=False and
return_softmax take the general path, in f32 as the JAX package's
general path computes them (a plain log_softmax composition).

linear_cross_entropy never builds the [N, vocab] logits at all: the head
projection streams through vocab blocks with an online logsumexp, and
the backward rematerialises each block (_LinearCE).
"""
from __future__ import annotations

import torch

from ...amp.auto_cast import amp_cast

__all__ = ["cross_entropy", "softmax_with_cross_entropy",
           "linear_cross_entropy"]

_CHUNK_ELEMS = 1 << 26
# the padded vocab columns' bias: exp(-1e30 - m) == 0 in the logsumexp
_PAD_BIAS = -1e30


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


def _check_last_axis(axis, ndim, what):
    if axis % ndim != ndim - 1:
        raise NotImplementedError(f"{what}: only the last axis is ported")


def _is_soft(logits, label, soft_label):
    return soft_label or (label.is_floating_point()
                          and label.shape == logits.shape)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False, name=None):
    """Per-row loss with a trailing 1 dim, as Paddle returns it; with
    return_softmax, (loss, softmax(logits)). An AMP black-list op
    ("softmax_with_cross_entropy_op"): float32 under auto_cast."""
    _check_last_axis(axis, logits.dim(), "softmax_with_cross_entropy")
    (logits,) = amp_cast("softmax_with_cross_entropy_op", logits)
    if not soft_label and not return_softmax:
        loss, _ = _fused_hard_label_ce(logits, label, ignore_index)
        return loss[..., None]
    logp = torch.log_softmax(logits, dim=-1)
    if soft_label:
        loss = -(label * logp).sum(-1, keepdim=True)
    else:
        lbl = label.squeeze(-1) if label.dim() == logits.dim() else label
        ignored = lbl == ignore_index
        safe = torch.where(ignored, torch.zeros_like(lbl), lbl)
        picked = logp.gather(-1, safe[..., None].to(torch.int64))
        loss = torch.where(ignored[..., None], 0.0, -picked)
    if return_softmax:
        return loss, torch.softmax(logits, dim=-1)
    return loss


def _general_ce(logits, label, weight, ignore_index, soft, use_softmax,
                label_smoothing):
    """The JAX package's general cross_entropy path (f32): per-row loss,
    and for weighted hard labels the per-row weight (None otherwise)."""
    if logits.is_floating_point() and logits.dtype != torch.float32:
        logits = logits.float()
    logp = (torch.log_softmax(logits, dim=-1) if use_softmax
            else torch.log(torch.clamp(logits, min=1e-30)))
    n_classes = logits.shape[-1]
    if soft:
        lbl = label
        if label_smoothing > 0:
            lbl = lbl * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -(lbl * logp).sum(-1)
        if weight is not None:
            loss = loss * (lbl * weight).sum(-1)
        return loss, None
    lbl = label.squeeze(-1) if (label.dim() == logits.dim()
                                and label.shape[-1] == 1) else label
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl)).to(torch.int64)
    if label_smoothing > 0:
        onehot = torch.nn.functional.one_hot(safe, n_classes).to(logp.dtype)
        smooth = onehot * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -(smooth * logp).sum(-1)
    else:
        loss = -logp.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, loss, 0.0)
    if weight is None:
        return loss, valid
    w = torch.where(valid, weight[safe], 0.0)
    return loss * w, w


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy over the last axis.

    Hard labels with no weight and no smoothing take the fused path:
    bf16 logits stay bf16 (cross_entropy is on neither AMP list) and
    "mean" averages over the rows whose label is not ignore_index. The
    other forms compute in f32: soft labels (soft_label, or float labels
    shaped like the logits), class `weight` ("mean" divides by the
    summed weights of the valid rows), label_smoothing and
    use_softmax=False (the input is probabilities)."""
    _check_last_axis(axis, input.dim(), "cross_entropy")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    soft = _is_soft(input, label, soft_label)
    if (use_softmax and not soft and weight is None
            and not label_smoothing):
        loss, valid = _fused_hard_label_ce(input, label, ignore_index)
        if reduction == "mean":
            return loss.sum() / torch.clamp(valid.sum().to(loss.dtype),
                                            min=1.0)
        return loss.sum() if reduction == "sum" else loss
    loss, norm = _general_ce(input, label, weight, ignore_index, soft,
                             use_softmax, label_smoothing)
    if reduction == "mean":
        if norm is None:
            return loss.mean()
        if weight is not None:
            return loss.sum() / torch.clamp(norm.sum(), min=1e-10)
        return loss.sum() / torch.clamp(norm.sum().to(loss.dtype), min=1.0)
    return loss.sum() if reduction == "sum" else loss


# -- vocab-chunked fused projection + CE ------------------------------------

def _vocab_blocks(vocab, block):
    """(number of blocks, padded vocab, padded columns) of a vocab of
    `vocab` columns cut into blocks of `block`."""
    block = int(block)
    nb = -(-int(vocab) // block)
    return nb, nb * block, nb * block - int(vocab)


def _block(w_t, bias, v0, block, ct):
    """Columns [v0, v0 + block) of the head in the compute dtype ct: the
    weight block [D, block] and its bias [block]. Past the vocab the
    weight reads zeros and the bias -1e30, so padded columns add
    exp(-1e30 - m) == 0 to the logsumexp and can never be a label."""
    v = w_t.shape[1]
    v1 = min(v0 + block, v)
    w = w_t[:, v0:v1].to(ct)
    b = (bias[v0:v1] if bias is not None
         else torch.zeros(v1 - v0, dtype=ct, device=w_t.device)).to(ct)
    pad = block - (v1 - v0)
    if pad:
        w = torch.nn.functional.pad(w, (0, pad))
        b = torch.nn.functional.pad(b, (0, pad), value=_PAD_BIAS)
    return w, b


class _LinearCE(torch.autograd.Function):
    """Per-row f32 loss lse(h W + b) - (h W + b)[label] (0 where not
    valid) of h [N, D], w_t [D, V], bias [V] or None, labels int64 [N]
    (pre-clamped), valid bool [N], streamed through vocab blocks of
    `block` columns.

    The block products run in the promoted dtype of h and w_t (the JAX
    package's `h @ wblk` promotes alike) and widen to f32 for the online
    logsumexp. Saved for the backward: h, w_t, bias, the labels and the
    f32 lse [N], nothing of N x V elements."""

    @staticmethod
    def forward(ctx, h, w_t, bias, labels, valid, block):
        n = h.shape[0]
        ct = torch.promote_types(h.dtype, w_t.dtype)
        hc = h.to(ct)
        nb, _, _ = _vocab_blocks(w_t.shape[1], block)
        m = torch.full((n,), float("-inf"), dtype=torch.float32,
                       device=h.device)
        s = torch.zeros(n, dtype=torch.float32, device=h.device)
        picked = torch.zeros(n, dtype=torch.float32, device=h.device)
        for i in range(nb):
            v0 = i * block
            w, b = _block(w_t, bias, v0, block, ct)
            lg = torch.addmm(b, hc, w).float()
            mb = torch.maximum(m, lg.amax(dim=-1))
            s = s * torch.exp(m - mb) + torch.exp(lg - mb[:, None]).sum(-1)
            in_blk = (labels >= v0) & (labels < v0 + block)
            idx = torch.clamp(labels - v0, 0, block - 1)
            picked = torch.where(in_blk, lg.gather(1, idx[:, None])[:, 0],
                                 picked)
            m = mb
            del lg
        lse = m + torch.log(s)
        ctx.block = block
        ctx.has_bias = bias is not None
        ctx.save_for_backward(h, w_t, bias, labels, valid, lse)
        return torch.where(valid, lse - picked, 0.0)

    @staticmethod
    def backward(ctx, g):
        h, w_t, bias, labels, valid, lse = ctx.saved_tensors
        block = ctx.block
        ct = torch.promote_types(h.dtype, w_t.dtype)
        hc = h.to(ct)
        v = w_t.shape[1]
        nb, _, _ = _vocab_blocks(v, block)
        gm = torch.where(valid, g.float(), 0.0)[:, None]
        # dh is the only cross-block accumulator: f32, as in the JAX
        # package (a low-precision running sum would round after every
        # block, noisier than the dense path's one f32-accumulated matmul)
        dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        dw = torch.empty_like(w_t)
        db = torch.empty_like(bias) if ctx.has_bias else None
        for i in range(nb):
            v0 = i * block
            v1 = min(v0 + block, v)
            w, b = _block(w_t, bias, v0, block, ct)
            p = torch.addmm(b, hc, w).float().sub_(lse[:, None]).exp_()
            # p - onehot in f32 (BEFORE the cast to the compute dtype):
            # minus one at the label column of the rows whose label lies
            # in this block
            in_blk = (labels >= v0) & (labels < v0 + block)
            idx = torch.clamp(labels - v0, 0, block - 1)
            p.scatter_add_(1, idx[:, None], -in_blk.float()[:, None])
            dlg = p.mul_(gm).to(ct)
            del p
            dh += (dlg @ w.t()).float()
            # padded columns have p == 0: dW and db keep the first V
            dlg = dlg[:, :v1 - v0]
            dw[:, v0:v1] = (hc.t() @ dlg).to(dw.dtype)
            if db is not None:
                db[v0:v1] = dlg.float().sum(0).to(db.dtype)
        return dh.to(h.dtype), dw, db, None, None, None


def linear_cross_entropy(hidden, weight_t, bias=None, label=None,
                         vocab_block=2048, ignore_index=-100,
                         reduction="mean", name=None):
    """Fused head projection + softmax cross-entropy WITHOUT building
    the [N, vocab] logits: vocab-blockwise online logsumexp, and a
    backward that rematerialises each block.

    hidden [N, D] (or [..., D], flattened); weight_t [D, V] (pass the
    embedding as `emb.t()` for a tied decoder); bias [V] or None; label
    int [N] (or the leading shape of hidden). A vocab that is not a
    multiple of vocab_block is padded up to one inside (zero weight
    columns, bias -1e30); dW comes back cut to V. On neither AMP list,
    as in the JAX package: the products run in the dtypes given (under
    O1 the head's f32 hidden states and the f32 master weight). Memory:
    O(N * vocab_block) live logits against O(N * V)."""
    h2 = hidden.reshape(-1, hidden.shape[-1])
    lbl = label.reshape(-1)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl)).to(torch.int64)
    loss = _LinearCE.apply(h2, weight_t, bias, safe, valid,
                           int(vocab_block))
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum().float(), min=1.0)
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss.reshape(label.shape)
    raise ValueError(f"reduction must be mean, sum or none, got "
                     f"{reduction!r}")
