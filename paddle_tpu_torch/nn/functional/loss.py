"""Loss functionals (counterpart of paddle_tpu/nn/functional/loss.py).

The element-wise losses (BCE, NLL, MSE, L1, smooth L1, KL, the margin,
embedding, focal, dice, triplet, Poisson and Gaussian NLL losses) and
CTC are the JAX package's compositions in torch ops; CTC's dynamic
programme runs as a Python loop over time (the JAX package's lax.scan),
so it runs on either device. Those the JAX package's AMP black list
names (bce_loss, bce_with_logits, nll_loss_op, mse_loss_op, l1_loss_op,
kldiv_loss_op, ctc_loss_op) compute in float32 under auto_cast.

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
general path computes them (a plain log_softmax composition). So does
any class axis other than the last ([N, C, H, W] at axis 1): the
log-softmax, the picked label and the smoothing's one-hot all lie along
that axis, and the label may keep a 1 there.

linear_cross_entropy never builds the [N, vocab] logits at all: the head
projection streams through vocab blocks with an online logsumexp, and
the backward rematerialises each block (_LinearCE).
"""
from __future__ import annotations

import math

import torch

from ...amp.auto_cast import amp_cast

__all__ = [
    "hsigmoid_loss",
    "cross_entropy", "softmax_with_cross_entropy", "binary_cross_entropy",
    "binary_cross_entropy_with_logits", "nll_loss", "mse_loss", "l1_loss",
    "smooth_l1_loss", "kl_div", "margin_ranking_loss", "hinge_embedding_loss",
    "cosine_embedding_loss", "ctc_loss", "log_loss", "square_error_cost",
    "sigmoid_focal_loss", "softmax_with_cross_entropy_label_smooth",
    "triplet_margin_loss", "triplet_margin_with_distance_loss",
    "multi_label_soft_margin_loss", "soft_margin_loss", "dice_loss",
    "poisson_nll_loss", "gaussian_nll_loss", "linear_cross_entropy",
]

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


def _hard_labels(label, logits, axis):
    """Hard labels with the class axis squeezed out where they keep a 1
    there."""
    if label.dim() == logits.dim() and label.shape[axis] == 1:
        return label.squeeze(axis)
    return label


def _is_soft(logits, label, soft_label):
    return soft_label or (label.is_floating_point()
                          and label.shape == logits.shape)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1,
                               return_softmax=False, name=None):
    """Per-row loss with a 1 at the class axis `axis` (trailing for the
    last), as Paddle returns it; with return_softmax, (loss,
    softmax(logits) over `axis`). An AMP black-list op
    ("softmax_with_cross_entropy_op"): float32 under auto_cast."""
    axis = axis % logits.dim()
    (logits,) = amp_cast("softmax_with_cross_entropy_op", logits)
    if not soft_label and not return_softmax and axis == logits.dim() - 1:
        loss, _ = _fused_hard_label_ce(logits, label, ignore_index)
        return loss[..., None]
    logp = torch.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -(label * logp).sum(axis, keepdim=True)
    else:
        lbl = label.squeeze(axis) if label.dim() == logits.dim() else label
        ignored = (lbl == ignore_index).unsqueeze(axis)
        safe = torch.where(ignored, 0, lbl.unsqueeze(axis))
        picked = logp.gather(axis, safe.to(torch.int64))
        loss = torch.where(ignored, 0.0, -picked)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def _general_ce(logits, label, weight, ignore_index, soft, use_softmax,
                label_smoothing, axis):
    """The JAX package's general cross_entropy path (f32) over the class
    axis `axis` (non-negative): per-row loss, and for weighted hard
    labels the per-row weight (None otherwise)."""
    if logits.is_floating_point() and logits.dtype != torch.float32:
        logits = logits.float()
    logp = (torch.log_softmax(logits, dim=axis) if use_softmax
            else torch.log(torch.clamp(logits, min=1e-30)))
    n_classes = logits.shape[axis]
    if soft:
        lbl = label
        if label_smoothing > 0:
            lbl = lbl * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -(lbl * logp).sum(axis)
        if weight is not None:
            # the class weights along the class axis
            w = weight.reshape((-1,) + (1,) * (logits.dim() - 1 - axis))
            loss = loss * (lbl * w).sum(axis)
        return loss, None
    lbl = _hard_labels(label, logits, axis)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, torch.zeros_like(lbl)).to(torch.int64)
    if label_smoothing > 0:
        onehot = torch.nn.functional.one_hot(safe, n_classes).to(logp.dtype)
        smooth = onehot * (1 - label_smoothing) + label_smoothing / n_classes
        loss = -(smooth.movedim(-1, axis) * logp).sum(axis)
    else:
        loss = -logp.gather(axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, loss, 0.0)
    if weight is None:
        return loss, valid
    w = torch.where(valid, weight[safe], 0.0)
    return loss * w, w


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """Softmax cross-entropy over the class axis `axis`.

    Hard labels over the last axis with no weight and no smoothing take
    the fused path: bf16 logits stay bf16 (cross_entropy is on neither
    AMP list) and "mean" averages over the rows whose label is not
    ignore_index. The other forms compute in f32: soft labels
    (soft_label, or float labels shaped like the logits), class `weight`
    ("mean" divides by the summed weights of the valid rows),
    label_smoothing, use_softmax=False (the input is probabilities) and
    any other class axis."""
    axis = axis % input.dim()
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be mean, sum or none, got "
                         f"{reduction!r}")
    soft = _is_soft(input, label, soft_label)
    if (use_softmax and not soft and weight is None
            and not label_smoothing and axis == input.dim() - 1):
        loss, valid = _fused_hard_label_ce(input, label, ignore_index)
        if reduction == "mean":
            return loss.sum() / torch.clamp(valid.sum().to(loss.dtype),
                                            min=1.0)
        return loss.sum() if reduction == "sum" else loss
    loss, norm = _general_ce(input, label, weight, ignore_index, soft,
                             use_softmax, label_smoothing, axis)
    if reduction == "mean":
        if norm is None:
            return loss.mean()
        if weight is not None:
            return loss.sum() / torch.clamp(norm.sum(), min=1e-10)
        return loss.sum() / torch.clamp(norm.sum().to(loss.dtype), min=1.0)
    return loss.sum() if reduction == "sum" else loss


def _reduce(loss, reduction):
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _softplus_neg_abs(x):
    """log(1 + exp(-|x|)), the stable tail of the logistic losses."""
    return torch.log1p(torch.exp(-x.abs()))


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    input, label, weight = amp_cast("bce_loss", input, label, weight)
    eps = 1e-12
    loss = -(label * torch.log(torch.clamp(input, min=eps))
             + (1 - label) * torch.log(torch.clamp(1 - input, min=eps)))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    logit, label, weight, pos_weight = amp_cast(
        "bce_with_logits", logit, label, weight, pos_weight)
    max_val = torch.clamp(-logit, min=0.0)
    if pos_weight is not None:
        log_w = (pos_weight - 1.0) * label + 1.0
        loss = (1 - label) * logit + log_w * (_softplus_neg_abs(logit)
                                              + max_val)
    else:
        loss = (1 - label) * logit + max_val + _softplus_neg_abs(logit)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """input [N, C] log-probabilities, label [N]. "mean" divides by the
    valid rows' summed weights (their count without weight)."""
    input, weight = amp_cast("nll_loss_op", input, weight)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    loss = -input.gather(1, safe[:, None])[:, 0]
    if weight is not None:
        w = weight[safe]
        loss = torch.where(valid, loss * w, 0.0)
        if reduction == "mean":
            return loss.sum() / torch.where(valid, w, 0.0).sum()
    loss = torch.where(valid, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.sum().to(loss.dtype), min=1.0)
    return _reduce(loss, reduction)


def mse_loss(input, label, reduction="mean", name=None):
    input, label = amp_cast("mse_loss_op", input, label)
    d = input - label
    return _reduce(d * d, reduction)


def l1_loss(input, label, reduction="mean", name=None):
    input, label = amp_cast("l1_loss_op", input, label)
    return _reduce((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = (input - label).abs()
    loss = torch.where(d < delta, 0.5 * d * d / delta, d - 0.5 * delta)
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False, name=None):
    input, label = amp_cast("kldiv_loss_op", input, label)
    if log_target:
        loss = torch.exp(label) * (label - input)
    else:
        loss = label * (torch.log(torch.clamp(label, min=1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    loss = torch.clamp(-label * (input - other) + margin, min=0.0)
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1.0, input,
                       torch.clamp(margin - input, min=0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0, reduction="mean",
                          name=None):
    cos = ((input1 * input2).sum(-1)
           / torch.clamp(torch.linalg.vector_norm(input1, dim=-1)
                         * torch.linalg.vector_norm(input2, dim=-1),
                         min=1e-12))
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
    return _reduce(loss, reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return -(label * torch.log(input + epsilon)
             + (1 - label) * torch.log(1 - input + epsilon))


def square_error_cost(input, label):
    d = input - label
    return d * d


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = (1 - label) * logit + torch.clamp(-logit, min=0.0) \
        + _softplus_neg_abs(logit)
    p_t = p * label + (1 - p) * (1 - label)
    loss = ce * torch.pow(1 - p_t, gamma)
    if alpha >= 0:
        loss = (alpha * label + (1 - alpha) * (1 - label)) * loss
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """input [..., C] probabilities, label [..., 1] class ids."""
    lbl = torch.nn.functional.one_hot(label.squeeze(-1).long(),
                                      input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = (input * lbl).sum(dims)
    denom = input.sum(dims) + lbl.sum(dims)
    return (1 - (2 * inter + epsilon) / (denom + epsilon)).mean()


def soft_margin_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.log1p(torch.exp(-label * input)), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean", name=None):
    ls = torch.nn.functional.logsigmoid
    loss = -(label * ls(input) + (1 - label) * ls(-input)).mean(-1)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    def dist(a, b):
        return torch.pow(torch.pow((a - b).abs() + epsilon, p).sum(-1),
                         1.0 / p)
    d_pos = dist(input, positive)
    d_neg = dist(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, dist(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean",
                                      name=None):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    d_pos = distance_function(input, positive)
    d_neg = distance_function(input, negative)
    if swap:
        d_neg = torch.minimum(d_neg, distance_function(positive, negative))
    return _reduce(torch.clamp(d_pos - d_neg + margin, min=0.0), reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean", name=None):
    if log_input:
        loss = torch.exp(input) - label * input
    else:
        loss = input - label * torch.log(input + epsilon)
    if full:
        lab1 = torch.clamp(label, min=1.0)
        stirling = (label * torch.log(lab1) - label
                    + 0.5 * torch.log(2 * math.pi * lab1))
        loss = loss + torch.where(label > 1, stirling, 0.0)
    return _reduce(loss, reduction)


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean", name=None):
    var = torch.clamp(variance, min=epsilon)
    d = input - label
    loss = 0.5 * (torch.log(var) + d * d / var)
    if full:
        loss = loss + 0.5 * math.log(2 * math.pi)
    return _reduce(loss, reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC loss (reference warpctc_op) by the forward recursion in log
    space over the blank-extended labels: log_probs [T, B, C] (Paddle's
    layout), labels [B, L]. Each sample's alphas freeze past its input
    length; its loss is -log of the two end states at 2 * label_length
    and the one before it."""
    (log_probs,) = amp_cast("ctc_loss_op", log_probs)
    t_steps, b, _ = log_probs.shape
    n_lab = labels.shape[1]
    s = 2 * n_lab + 1
    dev = log_probs.device
    ext = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels.long()
    neg_inf = -1e30
    lp_ext = log_probs.permute(1, 0, 2).gather(
        2, ext[:, None, :].expand(b, t_steps, s))        # [B, T, S]
    same_as_prev2 = torch.cat(
        [torch.ones((b, 2), dtype=torch.bool, device=dev),
         ext[:, 2:] == ext[:, :-2]], 1)
    fill = torch.full((b, 2), neg_inf, dtype=log_probs.dtype, device=dev)
    # t = 0: the leading blank and the first label (when there is one)
    head = lp_ext[:, 0, :min(2, s)]
    alpha = torch.cat([head, torch.full((b, s - head.shape[1]), neg_inf,
                                        dtype=log_probs.dtype,
                                        device=dev)], 1)
    in_len = input_lengths.to(dev)
    for t in range(1, t_steps):
        shift1 = torch.cat([fill[:, :1], alpha[:, :-1]], 1)
        shift2 = torch.where(same_as_prev2, neg_inf,
                             torch.cat([fill, alpha[:, :-2]], 1))
        new = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2) \
            + lp_ext[:, t]
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    end = 2 * label_lengths.to(dev).long()
    a_last = alpha.gather(1, end[:, None])[:, 0]
    a_last2 = alpha.gather(1, torch.clamp(end - 1, min=0)[:, None])[:, 0]
    ll = torch.logaddexp(a_last, torch.where(label_lengths.to(dev) > 0,
                                             a_last2, neg_inf))
    loss = -ll
    if norm_by_times:
        loss = loss / in_len.to(loss.dtype)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy_label_smooth(logits, label, epsilon=0.1):
    from .common import label_smooth, one_hot
    smooth = label_smooth(one_hot(label, logits.shape[-1]), epsilon=epsilon)
    return cross_entropy(logits, smooth, soft_label=True)


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """paddle.nn.functional.hsigmoid_loss (reference
    hierarchical_sigmoid_op) over the default complete binary tree;
    custom-tree path tables are not supported, as in the JAX package."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "custom-tree hsigmoid (path_table/path_code) is not "
            "supported; use the default complete binary tree")
    from ...ops.loss_extra import hierarchical_sigmoid
    cost, _ = hierarchical_sigmoid(input, label, weight, bias,
                                   num_classes=num_classes)
    return cost


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
