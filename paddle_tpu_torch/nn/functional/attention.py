"""Attention functionals: SDPA + blockwise (flash) attention.

Counterpart of paddle_tpu/nn/functional/attention.py, layout
[batch, seq, heads, head_dim] at every public function:

- scaled_dot_product_attention: a plain torch composition with the
  probabilities materialized (the attention_mask path).
- flash_attention: the hand-written CUDA forward kernel
  (paddle_tpu_torch/ops/flash_attention.py) for tensors on the card; the
  blockwise online softmax below for tensors on the CPU and for kv_lens
  (right-padded batches), routed exactly as the JAX package routes them.

The blockwise code (_flash_carry_init/_flash_carry_update/_flash_fwd/
_flash_headmajor) is the CPU tier and the plain version that the kernel
is held against. Training-mode attention dropout belongs to the training
slice and raises NotImplementedError here.
"""
from __future__ import annotations

import math

import torch

from ...ops import flash_attention as _fa

__all__ = ["scaled_dot_product_attention", "flash_attention"]

_NEG = -1e30


def _training_dropout():
    return NotImplementedError(
        "training slice: attention dropout in training mode is not ported "
        "yet; call model.eval() or set the dropout to 0")


def _sdpa_impl(q, k, v, attn_mask, is_causal, scale):
    d = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(d)
    qT, kT, vT = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    logits = torch.matmul(qT, kT.transpose(-1, -2)) * s
    if is_causal:
        ql, kl = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((ql, kl), dtype=torch.bool,
                          device=q.device).tril(kl - ql)
        logits = logits.masked_fill(~mask, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, vT).permute(0, 2, 1, 3)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None):
    if dropout_p and training:
        raise _training_dropout()
    return _sdpa_impl(query, key, value, attn_mask, is_causal, scale)


def _flash_carry_init(b, n, sq, hd, device):
    """Fresh online-softmax carry (acc, m, l) for blockwise attention."""
    return (torch.zeros((b, n, sq, hd), dtype=torch.float32, device=device),
            torch.full((b, n, sq), float("-inf"), dtype=torch.float32,
                       device=device),
            torch.zeros((b, n, sq), dtype=torch.float32, device=device))


def _flash_carry_update(q32, k, v, carry, block_k, pos_q, pos_k0, sk,
                        is_causal, kv_lens=None):
    """Consume one KV shard [b, n, s_kv, h] in block_k chunks, updating
    the online-softmax carry (acc, m, l). `pos_k0` is the shard's global
    key offset, `sk` its true length, `pos_q` the queries' global
    positions (causal masking is top-left: pos_q >= pos_k, as in the
    kernel). kv_lens [b]: per-batch true key length (right padding)."""
    acc, m, l = carry
    skl = k.shape[2]
    for j0 in range(0, skl, block_k):
        kj = k[:, :, j0:j0 + block_k].float()
        vj = v[:, :, j0:j0 + block_k].float()
        logits = torch.matmul(q32, kj.transpose(-1, -2))
        pos_k = pos_k0 + j0 + torch.arange(kj.shape[2], device=q32.device)
        valid = pos_k < pos_k0 + sk                      # [bk]
        if kv_lens is not None:
            valid = (valid[None, :] & (pos_k[None, :]
                                       < kv_lens[:, None]))[:, None, None]
        if is_causal:
            valid = valid & (pos_q[:, None] >= pos_k[None, :])
        logits = logits.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # guard fully-masked rows
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(logits - m_safe[..., None])
        p = torch.where(torch.isfinite(logits), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vj)
        m = m_new
    return acc, m, l


def _flash_finish(carry, dtype):
    acc, _, l = carry
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(dtype)


def _flash_fwd(q, k, v, is_causal, scale, block_k, kv_lens=None,
               return_lse=False):
    """Blockwise attention with online softmax over KV chunks.

    q,k,v: [b, n, s, h] (head-major). With return_lse, also returns the
    per-row log-sum-exp [b, n, sq] in f32 (rows with no valid key read
    -1e30, the kernel's mask value)."""
    b, n, sq, hd = q.shape
    sk = k.shape[2]
    q32 = q.float() * scale
    carry = _flash_carry_init(b, n, sq, hd, q.device)
    carry = _flash_carry_update(q32, k, v, carry, block_k,
                                torch.arange(sq, device=q.device), 0, sk,
                                is_causal, kv_lens=kv_lens)
    out = _flash_finish(carry, q.dtype)
    if not return_lse:
        return out
    _, m, l = carry
    m = torch.where(torch.isfinite(m), m, _NEG)
    return out, m + torch.log(torch.clamp(l, min=1e-30))


def _flash_headmajor(query, key, value, causal, block_size, kv_lens=None,
                     scale=None, return_lse=False):
    """Paddle-layout wrapper over _flash_fwd: [b,s,n,h] in/out,
    head-major inside, 1/sqrt(h) scaling, block clamped to sk."""
    q, k, v = (t.permute(0, 2, 1, 3) for t in (query, key, value))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    blk = max(1, min(block_size, k.shape[2]))
    res = _flash_fwd(q, k, v, causal, scale, blk, kv_lens=kv_lens,
                     return_lse=return_lse)
    if return_lse:
        return res[0].permute(0, 2, 1, 3), res[1]
    return res.permute(0, 2, 1, 3)


def _flash_attention_op(query, key, value, kv_lens=None, causal=False,
                        block_size=512):
    """No-dropout flash attention: the CUDA kernel for tensors on the
    card, the blockwise plain version on the CPU. kv_lens takes the
    blockwise path everywhere, as in the JAX package (the kernel's key
    bound is one scalar)."""
    if kv_lens is None:
        return _fa.flash_attention_mha(query, key, value, causal=causal)
    return _flash_headmajor(query, key, value, causal, block_size,
                            kv_lens=kv_lens)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, block_size=512, training=True,
                    name=None, kv_lens=None):
    """paddle.nn.functional.flash_attention-compatible entry.

    Layout [batch, seq, num_heads, head_dim]. Eval mode or dropout=0
    runs the deterministic forward; training-mode dropout raises until
    the training slice ports the in-kernel dropout. kv_lens [b]
    (int tensor on the same device): per-batch true key length for
    right-padded batches. return_softmax is an API-parity flag, as in
    the JAX package: no path returns the probabilities."""
    if dropout and training:
        raise _training_dropout()
    return _flash_attention_op(query, key, value, kv_lens, causal=causal,
                               block_size=block_size)
