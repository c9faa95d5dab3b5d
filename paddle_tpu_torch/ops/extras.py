"""Beam-search ops (the port's copies of gather_tree and beam_search_step
from paddle_tpu/ops/extras.py, and nothing else of that file)."""
from __future__ import annotations

import torch

__all__ = ["gather_tree", "beam_search_step"]


def gather_tree(ids, parents):
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


def beam_search_step(log_probs, scores, beam_size=4):
    """One beam-search expansion (ref beam_search_op.cc semantics,
    static-shape): log_probs [B, W, V] next-token scores, scores [B, W]
    running beam scores. Returns (new_scores [B, beam_size], token_ids,
    parent_ids), int64 ids.

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
