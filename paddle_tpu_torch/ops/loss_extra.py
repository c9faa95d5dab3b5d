"""Loss, ranking and ads-model ops from the reference's long tail
(counterpart of paddle_tpu/ops/loss_extra.py): hinge, huber, modified
huber, rank, BPR, center, teacher-student sigmoid, FSP, CVM, data_norm,
NCE and sampled logits (the reference's log-uniform sampler), the
default-tree hierarchical sigmoid and match_matrix_tensor.

nce and sample_logits draw their negatives from a torch.Generator: the
`generator` given, else one seeded with `seed`, else the port's default
generator of the input's device. JAX's random bits cannot be matched, so
the tests hold the draws' statistics and everything downstream of the
samples.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "hinge_loss", "huber_loss", "modified_huber_loss", "rank_loss",
    "bpr_loss", "center_loss", "teacher_student_sigmoid_loss", "fsp",
    "cvm", "data_norm", "nce", "sample_logits", "hierarchical_sigmoid",
    "match_matrix_tensor",
]


def hinge_loss(logits, labels, name=None):
    """max(0, 1 - logits (2 labels - 1)); labels in {0, 1}."""
    return torch.clamp(1.0 - logits * (2.0 * labels - 1.0), min=0.0)


def huber_loss(input, label, delta=1.0, name=None):
    """(residual, loss): r = label - input; 0.5 r^2 inside delta, delta
    (|r| - 0.5 delta) outside."""
    r = label - input
    a = torch.abs(r)
    return r, torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))


def modified_huber_loss(logits, labels, name=None):
    """v = logits (2 labels - 1): -4 v below -1, (1 - v)^2 below 1, else
    0."""
    v = logits * (2.0 * labels - 1.0)
    return torch.where(v < -1.0, -4.0 * v,
                       torch.where(v < 1.0, torch.square(1.0 - v),
                                   torch.zeros_like(v)))


def rank_loss(label, left, right, name=None):
    d = left - right
    return torch.log(1.0 + torch.exp(d)) - label * d


def bpr_loss(logits, label, name=None):
    """-mean over j != label of log(sigmoid(x_label - x_j)), per row
    ([B, 1]); exp(-d) clipped at 1e20 as the reference's
    TolerableValue."""
    b, c = logits.shape
    lbl = label.reshape(b).long()
    pos = logits.gather(1, lbl[:, None])
    logsig = -torch.log1p(torch.clamp(torch.exp(-(pos - logits)), 0.0, 1e20))
    mask = 1.0 - torch.nn.functional.one_hot(lbl, c).to(logits.dtype)
    return (-(logsig * mask).sum(1, keepdim=True) / (c - 1)).to(
        logits.dtype)


def center_loss(x, label, centers, alpha=0.05, need_update=True, name=None):
    """(loss [B, 1], x - centers[label], the centers after the update
    c -= alpha sum(diff_c) / (1 + count_c) when need_update)."""
    lbl = label.reshape(-1).long()
    diff = x - centers[lbl]
    loss = 0.5 * torch.sum(torch.square(diff), 1, keepdim=True)
    if not need_update:
        return loss, diff, centers
    k = centers.shape[0]
    sums = torch.zeros_like(centers).index_add(0, lbl, diff)
    counts = torch.zeros(k, dtype=x.dtype, device=x.device).index_add(
        0, lbl, torch.ones_like(lbl, dtype=x.dtype))
    return loss, diff, centers + alpha * sums / (1.0 + counts)[:, None]


def teacher_student_sigmoid_loss(x, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0, name=None):
    """The double sigmoid CE of the reference's label coding (label < -1:
    no click, no teacher; -1 <= label < 0: click, no teacher; else the
    click bit plus the teacher score)."""
    sp = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))
    z2 = torch.where(label < 1.0, label, label - 1.0)
    clk = (label >= 1.0).to(x.dtype)
    with_teacher = sp - clk * x + sp - z2 * x
    return torch.where(label < -1.0, sp,
                       torch.where(label < 0.0, sp - x, with_teacher))


def fsp(x, y, name=None):
    """The FSP matrix (fsp_op.h): out[b, i, j] = mean over h, w of
    x[b, i, h, w] y[b, j, h, w]."""
    return torch.einsum("bihw,bjhw->bij", x, y) / (x.shape[2] * x.shape[3])


def cvm(x, cvm_in=None, use_cvm=True, name=None):
    """Show/click transform (cvm_op.h): col 0 log(show + 1), col 1
    log(click + 1) - col 0 with use_cvm; else the two columns dropped."""
    if not use_cvm:
        return x[:, 2:]
    c0 = torch.log(x[:, 0:1] + 1.0)
    c1 = torch.log(x[:, 1:2] + 1.0) - c0
    return torch.cat([c0, c1, x[:, 2:]], dim=1)


def data_norm(x, batch_size, batch_sum, batch_square_sum, epsilon=1e-4,
              name=None):
    """(y, means, scales): means = batch_sum / batch_size, scales =
    sqrt(batch_size / batch_square_sum), y = (x - means) scales."""
    means = batch_sum / batch_size
    scales = torch.sqrt(batch_size / batch_square_sum)
    return (x - means[None, :]) * scales[None, :], means, scales


# -- the sampled-class ops, with the reference's log-uniform sampler:
#    P(x) = ln(1 + 1/(x + 1)) / ln(range + 1)  (math/sampler.h)

def _generator(device, seed, generator):
    if generator is not None:
        return generator
    if seed is not None:
        return torch.Generator(device=device).manual_seed(int(seed))
    from ..core.generator import default_generator
    return default_generator(device)


def _log_uniform_sample(gen, shape, range_, device):
    u = torch.rand(shape, generator=gen, device=device)
    s = torch.exp(u * float(np.log(range_ + 1.0))) - 1.0
    return torch.clamp(s.to(torch.int32), 0, range_ - 1)


def _log_uniform_prob(x, range_):
    return torch.log1p(1.0 / (x.to(torch.float32) + 1.0)) / float(
        np.log(range_ + 1.0))


def nce(x, label, weight, bias=None, num_total_classes=None,
        num_neg_samples=10, seed=None, sampler="log_uniform", name=None,
        generator=None):
    """Noise-contrastive estimation (nce_op.h): (cost [B, 1], the logits
    of [label, negatives], the samples [B, 1 + K]). o = sigmoid(x W[c] +
    b[c]); cost = -log(o / (o + kq)) for the true class and -log(kq /
    (o + kq)) for each negative, q the sampler's probability. Negatives
    from the uniform or the log-uniform sampler (_generator says which
    generator)."""
    n = int(num_total_classes or weight.shape[0])
    b, k = x.shape[0], int(num_neg_samples)
    gen = _generator(x.device, seed, generator)
    if sampler == "uniform":
        neg = torch.randint(0, n, (b, k), generator=gen, device=x.device,
                            dtype=torch.int32)
        q = torch.full((b, k), 1.0 / n, device=x.device)
    else:
        neg = _log_uniform_sample(gen, (b, k), n, x.device)
        q = _log_uniform_prob(neg, n)
    pos = label.reshape(b, 1).to(torch.int32)
    samples = torch.cat([pos, neg], dim=1)
    logits = torch.einsum("bd,bkd->bk", x, weight[samples.long()])
    if bias is not None:
        logits = logits + bias[samples.long()]
    o = torch.sigmoid(logits)
    qpos = (torch.full((b, 1), 1.0 / n, device=x.device)
            if sampler == "uniform" else _log_uniform_prob(pos, n))
    kq = k * torch.cat([qpos, q], dim=1)
    eps = 1e-12
    cost_true = -torch.log(o[:, :1] / (o[:, :1] + kq[:, :1]) + eps)
    cost_neg = -torch.log(kq[:, 1:] / (o[:, 1:] + kq[:, 1:]) + eps)
    cost = cost_true.sum(1, keepdim=True) + cost_neg.sum(1, keepdim=True)
    return cost, logits, samples


def sample_logits(logits, label, num_samples=10, seed=None, uniq=True,
                  remove_accidental_hits=True, use_customized_samples=False,
                  customized_samples=None, customized_probabilities=None,
                  name=None, generator=None):
    """Sampled-softmax gather (sample_logits_op.h): (samples [B, NT + S],
    their probabilities, the sampled logits logits[samples] - log(q), the
    sampled labels 0..NT-1). A negative that hits one of the row's true
    classes gets -1e20 added (remove_accidental_hits)."""
    b, n = logits.shape
    nt = label.shape[1] if label.dim() > 1 else 1
    pos = label.reshape(b, nt).to(torch.int32)
    if use_customized_samples:
        neg = customized_samples.to(torch.int32)
        q_neg = customized_probabilities
    else:
        gen = _generator(logits.device, seed, generator)
        neg = _log_uniform_sample(gen, (b, int(num_samples)), n,
                                  logits.device)
        q_neg = _log_uniform_prob(neg, n)
    samples = torch.cat([pos, neg], dim=1)
    probs = torch.cat([_log_uniform_prob(pos, n), q_neg.to(torch.float32)],
                      dim=1)
    sampled = logits.gather(1, samples.long()) - torch.log(probs + 1e-12)
    if remove_accidental_hits:
        hit = (neg[:, None, :] == pos[:, :, None]).any(1)
        sampled = torch.cat([sampled[:, :nt], sampled[:, nt:] + torch.where(
            hit, -1e20, 0.0).to(sampled.dtype)], dim=1)
    sampled_label = torch.arange(nt, dtype=torch.int32,
                                 device=logits.device)[None, :].expand(b, nt)
    return samples, probs, sampled, sampled_label


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


def match_matrix_tensor(x, y, w, dim_t=None, name=None):
    """Text-match tensors (match_matrix_tensor_op.cc): x [B, T1, D1], y
    [B, T2, D2], w [D1, C, D2] -> (out [B, C, T1, T2], tmp = x w [B, T1,
    C, D2])."""
    tmp = torch.einsum("bsd,dce->bsce", x, w)
    return torch.einsum("bsce,bte->bcst", tmp, y), tmp
