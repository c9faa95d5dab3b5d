"""The port's counterparts of paddle_tpu/ops/extras.py's vision sampling
and beam-search ops, and nothing else of that file: affine_grid,
grid_sample, max_unpool2d and diag_embed (nn.functional exports them;
torch's own functions compute each with Paddle's semantics, called here
with Paddle's argument names and defaults), gather_tree and
beam_search_step (the beam-search decoder's)."""
from __future__ import annotations

import torch

__all__ = ["affine_grid", "grid_sample", "max_unpool2d", "diag_embed",
           "gather_tree", "beam_search_step"]


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
