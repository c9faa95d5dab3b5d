"""The port's counterpart of paddle_tpu/ops/extras.py: vision sampling
(affine_grid, grid_sample, max_unpool2d and diag_embed through torch's
own functions, which compute each with Paddle's semantics, called with
Paddle's argument names and defaults), affine_channel, multiplex, the
segment pools, the linear-chain CRF and Viterbi decoding, beam search
(gather_tree, beam_search_step), diagonal and block_diag, the special
functions and py_func.

linear_chain_crf is the forward recursion over time, logsumexp by
logsumexp under autograd; viterbi_decode the max-product recursion with
back-pointers, then the backtrace. Both read nothing on the host, so
they run inside a captured step.
"""
from __future__ import annotations

import numpy as np
import torch

from ._args import tensor_of

__all__ = ["affine_grid", "grid_sample", "max_unpool2d", "multiplex",
           "segment_sum", "segment_mean", "segment_max", "segment_min",
           "linear_chain_crf", "viterbi_decode", "gather_tree",
           "beam_search_step", "diagonal", "diag_embed", "bucketize",
           "renorm", "poisson", "lgamma", "digamma", "polygamma", "logit",
           "frexp", "trapezoid", "cumulative_trapezoid", "vander", "cdist",
           "block_diag", "householder_product", "affine_channel",
           "py_func"]


# ---------------------------------------------------------------------------
# vision sampling
# ---------------------------------------------------------------------------

def affine_grid(theta, out_shape, align_corners=True, name=None):
    """Affine sampling grid (ref affine_grid_op.cc): theta [N, 2, 3],
    out_shape (N, C, H, W) -> grid [N, H, W, 2] of (x, y) in [-1, 1]
    source coordinates."""
    return torch.nn.functional.affine_grid(
        theta, [int(s) for s in out_shape], align_corners=align_corners)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample x [N, C, H, W] at grid [N, Ho, Wo, 2] ((x, y) in [-1, 1];
    ref grid_sampler_op.cc): bilinear or nearest (half to even), with
    zeros, border or reflection padding. Returns [N, C, Ho, Wo]."""
    return torch.nn.functional.grid_sample(
        x, grid, mode=mode, padding_mode=padding_mode,
        align_corners=align_corners)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 output_size=None, data_format="NCHW", name=None):
    """Inverse of max_pool2d with indices (ref unpool_op.cc): each pooled
    value written back at its argmax position of the [H_out * W_out]
    plane, zeros elsewhere."""
    if data_format != "NCHW":
        raise ValueError(
            f"max_unpool2d supports NCHW only, got {data_format!r}")
    if output_size is not None:
        output_size = [int(s) for s in output_size[-2:]]
    return torch.nn.functional.max_unpool2d(
        x, indices.long(), kernel_size, stride=stride, padding=padding,
        output_size=output_size)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    """Batched vectors -> batched diagonal matrices (ref diag_embed_op):
    [..., L] -> [..., m, m], m = L + |offset|, x on the offset diagonal."""
    return torch.diag_embed(x, offset=offset, dim1=dim1, dim2=dim2)


def affine_channel(x, scale, bias, data_format="NCHW", name=None):
    """Per-channel scale and bias (ref affine_channel_op.cc, the folded
    BatchNorm of detection models)."""
    if data_format == "NCHW":
        shape = (1, -1) + (1,) * (x.dim() - 2)
    else:
        shape = (1,) * (x.dim() - 1) + (-1,)
    return x * scale.reshape(shape) + bias.reshape(shape)


# ---------------------------------------------------------------------------
# manipulation / segment pools
# ---------------------------------------------------------------------------

def multiplex(inputs, index, name=None):
    """Row-wise select among candidate tensors (ref multiplex_op.cc):
    out[i] = inputs[index[i]][i]."""
    stacked = torch.stack(list(inputs), dim=0)
    idx = tensor_of(index, stacked).reshape(-1).long()
    return stacked[idx, torch.arange(stacked.shape[1],
                                     device=stacked.device)]


def _segments(data, segment_ids):
    ids = tensor_of(segment_ids, data).reshape(-1).long()
    return ids, int(ids.max()) + 1


def _fill(dtype, low):
    if dtype.is_floating_point:
        return float("-inf") if low else float("inf")
    info = torch.iinfo(dtype)
    return info.min if low else info.max


def segment_sum(data, segment_ids, name=None):
    """out[s] = the sum of the rows of data whose id is s; as many
    segments as the largest id + 1 (read on the host), an empty one 0."""
    ids, num = _segments(data, segment_ids)
    return data.new_zeros((num,) + tuple(data.shape[1:])).index_add(
        0, ids, data)


def segment_mean(data, segment_ids, name=None):
    """The mean of each segment's rows (0 for an empty one)."""
    ids, num = _segments(data, segment_ids)
    sums = data.new_zeros((num,) + tuple(data.shape[1:])).index_add(
        0, ids, data)
    counts = data.new_zeros((num,) + tuple(data.shape[1:])).index_add(
        0, ids, torch.ones_like(data))
    return sums / counts.clamp(min=1)


def _segment_extreme(data, segment_ids, low):
    ids, num = _segments(data, segment_ids)
    out = torch.full((num,) + tuple(data.shape[1:]), _fill(data.dtype, low),
                     dtype=data.dtype, device=data.device)
    index = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand(data.shape)
    return out.scatter_reduce(0, index, data, "amax" if low else "amin",
                              include_self=True)


def segment_max(data, segment_ids, name=None):
    """The elementwise max of each segment's rows (-inf, or the int
    minimum, for an empty one)."""
    return _segment_extreme(data, segment_ids, True)


def segment_min(data, segment_ids, name=None):
    """The elementwise min of each segment's rows (+inf, or the int
    maximum, for an empty one)."""
    return _segment_extreme(data, segment_ids, False)


def block_diag(inputs, name=None):
    """The block-diagonal matrix of the inputs (each at least 2-d), in
    the first one's dtype (ref paddle.block_diag)."""
    mats = [torch.atleast_2d(tensor_of(m)) for m in inputs]
    return torch.block_diag(*(m.to(mats[0].dtype) for m in mats))


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    """ref diagonal op (paddle.diagonal)."""
    return torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2)


# ---------------------------------------------------------------------------
# CRF / sequence decoding
# ---------------------------------------------------------------------------

def _crf_parts(transition, n, dtype, device, bos_eos=True):
    """(start, stop, pairwise) scores of a [N + 2, N] transition (row 0
    the start scores, row 1 the stop scores, rows 2.. the pairwise
    ones), or zeros and the whole [N, N] matrix without BOS/EOS rows."""
    if bos_eos:
        return transition[0], transition[1], transition[2:]
    zero = torch.zeros(n, dtype=dtype, device=device)
    return zero, zero, transition


def _length_mask(length, b, t, device):
    if length is None:
        length = torch.full((b,), t, dtype=torch.int64, device=device)
    length = tensor_of(length).reshape(-1).to(device).long()
    return length, torch.arange(t, device=device)[None, :] < length[:, None]


def linear_chain_crf(emission, transition, label, length=None, name=None):
    """Linear-chain CRF negative log-likelihood (ref
    linear_chain_crf_op.cc): emission [B, T, N], transition [N + 2, N]
    (row 0 the start scores, row 1 the stop scores, rows 2.. the
    pairwise ones, from tag i to tag j at [2 + i, j]), label [B, T] int,
    length [B] the valid lengths (all T when None). Returns the nll [B]:
    log Z (the forward recursion) minus the gold path's score."""
    b, t, n = emission.shape
    start, stop, trans = _crf_parts(transition, n, emission.dtype,
                                    emission.device)
    length, mask = _length_mask(length, b, t, emission.device)
    alpha = start[None] + emission[:, 0]
    for i in range(1, t):
        new = torch.logsumexp(emission[:, i, None, :] + trans[None]
                              + alpha[:, :, None], dim=1)
        alpha = torch.where(mask[:, i, None], new, alpha)
    logz = torch.logsumexp(alpha + stop[None], dim=1)
    lbl = tensor_of(label).reshape(b, t).long()
    maskf = mask.to(emission.dtype)
    emit_score = torch.sum(
        emission.gather(-1, lbl[..., None])[..., 0] * maskf, dim=1)
    pair_score = torch.sum(trans[lbl[:, :-1], lbl[:, 1:]] * maskf[:, 1:],
                           dim=1)
    last_lbl = lbl.gather(1, (length - 1).clamp(min=0)[:, None])[:, 0]
    gold = start[lbl[:, 0]] + emit_score + pair_score + stop[last_lbl]
    return logz - gold


def viterbi_decode(emission, transition, length=None,
                   include_bos_eos_tag=True, name=None):
    """The Viterbi best path (ref viterbi_decode_op / crf_decoding_op.cc):
    (scores [B], paths [B, T] int64). Past a row's length the path holds
    its last tag. Ties go to the lower tag, as jnp.argmax breaks them."""
    b, t, n = emission.shape
    start, stop, trans = _crf_parts(transition, n, emission.dtype,
                                    emission.device, include_bos_eos_tag)
    _, mask = _length_mask(length, b, t, emission.device)
    alpha = start[None] + emission[:, 0]
    back = []
    for i in range(1, t):
        cand = alpha[:, :, None] + trans[None]
        best = torch.argmax(cand, dim=1)
        new = torch.amax(cand, dim=1) + emission[:, i]
        alpha = torch.where(mask[:, i, None], new, alpha)
        back.append(best)
    final = alpha + stop[None]
    scores = torch.amax(final, dim=1)
    cur = torch.argmax(final, dim=1)
    path = [cur]
    for i in range(t - 1, 0, -1):
        prev = back[i - 1].gather(1, cur[:, None])[:, 0]
        cur = torch.where(mask[:, i], prev, cur)
        path.append(cur)
    return scores, torch.stack(path[::-1], dim=1).to(torch.int64)


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

def gather_tree(ids, parents, name=None):
    """Back-trace beam-search parent pointers into full sequences (ref
    gather_tree_op.cc). ids/parents [T, B, W]. Returns [T, B, W]: the
    token of every step on the path that ends in each final beam."""
    t, b, w = ids.shape
    beam = torch.arange(w, device=ids.device).expand(b, w)
    parents = parents.long()
    out = torch.empty_like(ids)
    for step in range(t - 1, -1, -1):
        out[step] = torch.gather(ids[step], 1, beam)
        beam = torch.gather(parents[step], 1, beam)
    return out


def beam_search_step(log_probs, scores, beam_size=4, end_token=None,
                     name=None):
    """One beam-search expansion (ref beam_search_op.cc semantics,
    static-shape): log_probs [B, W, V] next-token scores, scores [B, W]
    running beam scores. Returns (new_scores [B, beam_size], token_ids,
    parent_ids), int64 ids. end_token is accepted and unused, as in the
    JAX op: the caller freezes finished beams.

    The top beam_size of the W*V candidates, ties broken by the lower
    flat index, as jax.lax.top_k breaks them: torch.topk promises no
    order among ties, and a finished beam's frozen -1e30 row makes ties
    likely, so this is a stable descending sort cut to the first
    beam_size."""
    b, w, v = log_probs.shape
    flat = (scores[:, :, None] + log_probs).reshape(b, w * v)
    new_scores, idx = torch.sort(flat, dim=-1, descending=True,
                                 stable=True)
    new_scores, idx = new_scores[:, :beam_size], idx[:, :beam_size]
    return new_scores, idx % v, idx // v


# ---------------------------------------------------------------------------
# special math
# ---------------------------------------------------------------------------

def lgamma(x, name=None):
    """ref lgamma_op (an int input computes in float32)."""
    x = tensor_of(x)
    return torch.lgamma(x if x.is_floating_point() else x.float())


def digamma(x, name=None):
    """ref digamma_op."""
    return torch.digamma(x)


def polygamma(x, n, name=None):
    """ref polygamma op (paddle.polygamma): the n-th derivative of
    digamma."""
    return torch.polygamma(int(n), x)


def poisson(x, name=None):
    """Poisson(lambda = x) samples, elementwise (ref poisson_op), from the
    port's default generator of x's device (paddle.seed sets it)."""
    from ..core.generator import default_generator
    return torch.poisson(x, generator=default_generator(x.device))


def logit(x, eps=None, name=None):
    """ref logit_op: log(x / (1 - x)), x clipped to [eps, 1 - eps] when
    eps is given."""
    if eps is not None:
        x = torch.clamp(x, eps, 1.0 - eps)
    return torch.log(x) - torch.log1p(-x)


def frexp(x, name=None):
    """ref paddle.frexp: (mantissa, int32 exponent)."""
    return torch.frexp(tensor_of(x))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    """ref bucketize: searchsorted of x over a 1-d boundary set."""
    return torch.searchsorted(tensor_of(sorted_sequence, x), x,
                              out_int32=out_int32, right=right)


def renorm(x, p, axis, max_norm, name=None):
    """ref renorm_op: the slices along `axis` whose p-norm exceeds
    max_norm scaled down to it (max_norm / (norm + 1e-7))."""
    axes = tuple(i for i in range(x.dim()) if i != axis % x.dim())
    norms = torch.sum(torch.abs(x) ** p, dim=axes, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """ref paddle.trapezoid: the trapezoidal rule along axis, at the
    sample points x or the spacing dx (1 when neither is given)."""
    if x is not None:
        return torch.trapezoid(y, tensor_of(x, y), dim=axis)
    return torch.trapezoid(y, dx=dx or 1.0, dim=axis)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """ref paddle.cumulative_trapezoid: the running trapezoidal sums."""
    y = torch.movedim(y, axis, -1)
    if x is not None:
        x = tensor_of(x, y)
        d = torch.diff(torch.movedim(x, axis, -1) if x.dim() > 1 else x,
                       dim=-1)
    else:
        d = dx or 1.0
    out = torch.cumsum((y[..., 1:] + y[..., :-1]) / 2.0 * d, dim=-1)
    return torch.movedim(out, -1, axis)


def vander(x, n=None, increasing=False, name=None):
    """ref paddle.vander: the powers of x, decreasing unless increasing."""
    m = n if n is not None else x.shape[0]
    powers = torch.arange(m, device=x.device)
    if not increasing:
        powers = powers.flip(0)
    return x[:, None] ** powers[None, :].to(x.dtype)


def cdist(x, y, p=2.0, compute_mode=None, name=None):
    """The pairwise p-distances of two row sets (ref paddle.cdist): x
    [..., M, D], y [..., N, D] -> [..., M, N]. p 2 is sqrt(sum of
    squares + 1e-30), as the JAX op computes it (a finite gradient at
    distance 0)."""
    diff = x[..., :, None, :] - y[..., None, :, :]
    if p == 2.0:
        return torch.sqrt(torch.sum(diff * diff, -1) + 1e-30)
    if p == float("inf"):
        return torch.amax(torch.abs(diff), -1)
    return torch.sum(torch.abs(diff) ** p, -1) ** (1.0 / p)


def householder_product(x, tau, name=None):
    """The [M, M] Q of the Householder reflectors in the columns of x [...,
    M, N] with factors tau [..., N] (ref householder_product / LAPACK
    orgqr), as the JAX op builds it: Q = H_0 ... H_{N-1}."""
    m, n = x.shape[-2], x.shape[-1]
    rows = torch.arange(m, device=x.device)
    q = torch.eye(m, dtype=x.dtype, device=x.device).expand(
        x.shape[:-2] + (m, m))
    for i in range(n - 1, -1, -1):
        v = torch.where(rows < i, 0.0, x[..., :, i])
        v = torch.where(rows == i, 1.0, v)
        vq = torch.einsum("...k,...kj->...j", v, q)
        q = q - tau[..., i, None, None] * torch.einsum("...i,...j->...ij",
                                                      v, vq)
    return q


# ---------------------------------------------------------------------------
# py_func: arbitrary Python as an op (ref py_func_op.cc)
# ---------------------------------------------------------------------------

def py_func(func, x, out_shape=None, out_dtype="float32",
            backward_func=None, name=None):
    """func run on the inputs as numpy arrays on the host (ref
    operators/py_func_op.cc), its result a tensor on the first input's
    device (a float64 result as float32, as the JAX op gives it). No
    gradient flows through it, as through the JAX op."""
    xs = x if isinstance(x, (list, tuple)) else (x,)
    out = np.asarray(func(*[tensor_of(a).detach().cpu().numpy()
                            for a in xs]))
    if out.dtype == np.float64:
        out = out.astype(np.float32)
    dev = xs[0].device if isinstance(xs[0], torch.Tensor) else None
    return torch.as_tensor(out, device=dev)
