"""Attention functionals: SDPA + blockwise (flash) attention.

Counterpart of paddle_tpu/nn/functional/attention.py, layout
[batch, seq, heads, head_dim] at every public function:

- scaled_dot_product_attention: a plain torch composition with the
  probabilities materialized (the attention_mask path), with dropout on
  the normalized probabilities in training.
- flash_attention: the hand-written CUDA kernels
  (paddle_tpu_torch/ops/flash_attention.py, forward and backward through
  a torch.autograd.Function) for tensors on the card; the blockwise
  online softmax below for tensors on the CPU and for kv_lens
  (right-padded batches), which the JAX package too sends to a plain
  composition (XLA ops) rather than to its kernel. Training-mode
  attention dropout follows attention_dropout_impl(): the kernels for
  every CUDA tensor without kv_lens.

The blockwise code (_flash_carry_init/_flash_carry_update/_flash_fwd/
_flash_headmajor) is the CPU tier and the plain version that the kernels
are held against. Its dropout draws the same Philox mask as the kernels
(ops/philox.py), so the CPU tier and the card agree bit for bit on which
links are dropped.
"""
from __future__ import annotations

import math
import os

import torch

from ...amp.auto_cast import amp_cast
from ...core.generator import next_seed, seed_tensor
from ...ops import flash_attention as _fa
from ...ops import philox as _philox

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "attention_dropout_impl"]

_NEG = -1e30


def _bh_index(b, n, device):
    """[b, n, 1, 1] int64: the b*n + head index of the Philox counter."""
    return (torch.arange(b, device=device)[:, None] * n
            + torch.arange(n, device=device)[None, :])[..., None, None]


def _sdpa_impl(q, k, v, attn_mask, dropout_p, is_causal, scale,
               seed=None):
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
    if seed is not None and dropout_p > 0.0:
        # dropout on the NORMALIZED probabilities, as the JAX package
        # drops them; the links are those the flash kernels drop
        b, n, sq, sk = probs.shape
        keep = _philox.keep_mask(
            seed_tensor(seed, q.device), dropout_p,
            _bh_index(b, n, q.device),
            torch.arange(sq, device=q.device)[:, None],
            torch.arange(sk, device=q.device)[None, :])
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            0.0).to(probs.dtype)
    return torch.matmul(probs, vT).permute(0, 2, 1, 3)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None, name=None):
    drop = bool(dropout_p and training)
    if drop:
        _fa._check_dropout(dropout_p)
    query, key, value = amp_cast(
        "sdpa_dropout" if drop else "scaled_dot_product_attention",
        query, key, value)
    seed = next_seed(query.device) if drop else None
    return _sdpa_impl(query, key, value, attn_mask, float(dropout_p),
                      is_causal, scale, seed=seed)


def _flash_carry_init(b, n, sq, hd, device, dtype=torch.float32):
    """Fresh online-softmax carry (acc, m, l) for blockwise attention."""
    return (torch.zeros((b, n, sq, hd), dtype=dtype, device=device),
            torch.full((b, n, sq), float("-inf"), dtype=dtype,
                       device=device),
            torch.zeros((b, n, sq), dtype=dtype, device=device))


def _flash_carry_update(q32, k, v, carry, block_k, pos_q, pos_k0, sk,
                        is_causal, kv_lens=None, dropout=None):
    """Consume one KV shard [b, n, s_kv, h] in block_k chunks, updating
    the online-softmax carry (acc, m, l). `pos_k0` is the shard's global
    key offset, `sk` its true length, `pos_q` the queries' global
    positions (causal masking is top-left: pos_q >= pos_k, as in the
    kernel). kv_lens [b]: per-batch true key length (right padding).
    dropout=(seed, p): flash-style attention-probs dropout, l summing
    the UN-dropped probabilities while acc takes p*keep/(1-p) V, with the
    Philox mask of (seed, b*n + head, query, key); seed an int, a 0-d
    int64 tensor or a Draw (core/generator.py seed_tensor)."""
    acc, m, l = carry
    b, n = q32.shape[0], q32.shape[1]
    skl = k.shape[2]
    bh = _bh_index(b, n, q32.device) if dropout is not None else None
    if dropout is not None:
        dropout = (seed_tensor(dropout[0], q32.device), dropout[1])
    for j0 in range(0, skl, block_k):
        kj = k[:, :, j0:j0 + block_k].to(q32.dtype)
        vj = v[:, :, j0:j0 + block_k].to(q32.dtype)
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
        if dropout is not None:
            seed, rate = dropout
            keep = _philox.keep_mask(seed, rate, bh, pos_q[:, None],
                                     pos_k[None, :])
            p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
        acc = acc * corr[..., None] + torch.matmul(p, vj)
        m = m_new
    return acc, m, l


def _flash_finish(carry, dtype):
    acc, _, l = carry
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(dtype)


def _flash_fwd(q, k, v, is_causal, scale, block_k, kv_lens=None,
               return_lse=False, dropout=None):
    """Blockwise attention with online softmax over KV chunks.

    q,k,v: [b, n, s, h] (head-major). Accumulates in f32 (f64 for f64
    inputs). With return_lse, also returns the per-row log-sum-exp
    [b, n, sq] (rows with no valid key read -1e30, the kernel's mask
    value). dropout=(seed, p) applies the Philox attention dropout."""
    b, n, sq, hd = q.shape
    sk = k.shape[2]
    acc_t = torch.float64 if q.dtype == torch.float64 else torch.float32
    q32 = q.to(acc_t) * scale
    carry = _flash_carry_init(b, n, sq, hd, q.device, acc_t)
    carry = _flash_carry_update(q32, k, v, carry, block_k,
                                torch.arange(sq, device=q.device), 0, sk,
                                is_causal, kv_lens=kv_lens, dropout=dropout)
    out = _flash_finish(carry, q.dtype)
    if not return_lse:
        return out
    _, m, l = carry
    m = torch.where(torch.isfinite(m), m, _NEG)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return out, lse if acc_t == torch.float64 else lse.float()


def _flash_headmajor(query, key, value, causal, block_size, kv_lens=None,
                     scale=None, return_lse=False, dropout=None):
    """Paddle-layout wrapper over _flash_fwd: [b,s,n,h] in/out,
    head-major inside, 1/sqrt(h) scaling, block clamped to sk."""
    q, k, v = (t.permute(0, 2, 1, 3) for t in (query, key, value))
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    blk = max(1, min(block_size, k.shape[2]))
    res = _flash_fwd(q, k, v, causal, scale, blk, kv_lens=kv_lens,
                     return_lse=return_lse, dropout=dropout)
    if return_lse:
        return res[0].permute(0, 2, 1, 3), res[1]
    return res.permute(0, 2, 1, 3)


def _flash_attention_op(query, key, value, kv_lens=None, causal=False,
                        block_size=512):
    """No-dropout flash attention: the CUDA kernels for tensors on the
    card, the plain versions on the CPU. kv_lens takes the blockwise
    composition on every device, as the JAX package routes it to XLA ops
    rather than to its Pallas kernel (the kernel's key bound is one
    scalar; taking kv_lens into it is open in ROADMAP.md queue B)."""
    query, key, value = amp_cast("flash_attention_op", query, key, value)
    if kv_lens is None:
        return _fa.flash_attention_mha(query, key, value, causal=causal)
    return _flash_headmajor(query, key, value, causal, block_size,
                            kv_lens=kv_lens)


_IMPLS = ("kernel", "blockwise", "sdpa")


def attention_dropout_impl(device="cuda") -> str:
    """Which implementation training-mode attention dropout dispatches
    to for tensors on `device`. Tensors on the card always run the CUDA
    kernels ("kernel"): the card has no other route; meta tensors (a card
    step traced from shapes alone) take the same route. For CPU tensors the
    default is "blockwise" (the plain blockwise flash dropout), and
    PD_ATTN_DROPOUT_IMPL may pick "sdpa" (materialized probabilities) or
    "kernel" (the autograd Function, whose CPU half is the plain
    version). A value other than these raises ValueError, on either
    device, rather than being ignored."""
    forced = os.environ.get("PD_ATTN_DROPOUT_IMPL", "").strip().lower()
    if forced and forced not in _IMPLS:
        raise ValueError(
            f"PD_ATTN_DROPOUT_IMPL={forced!r}: must be kernel, "
            "blockwise, or sdpa")
    if torch.device(device).type in ("cuda", "meta"):
        # the meta device traces a card step (TrainStep.aot_lower)
        return "kernel"
    return forced or "blockwise"


def _flash_attention_dropout_op(query, key, value, seed, kv_lens=None,
                                causal=False, dropout_p=0.0,
                                block_size=512):
    """Training-mode flash attention with attention-probs dropout, on the
    tier attention_dropout_impl() names. `seed` is the 64-bit Philox seed
    of this call. kv_lens takes the blockwise composition on every
    device, as the JAX package routes it to XLA ops rather than to its
    Pallas kernel (the kernels' key bound is one scalar; taking kv_lens
    into them is open in ROADMAP.md queue B)."""
    query, key, value = amp_cast("flash_attention_dropout", query, key,
                                 value)
    impl = attention_dropout_impl(query.device)
    if impl == "kernel" and kv_lens is None:
        return _fa.flash_attention_mha(query, key, value, causal=causal,
                                       dropout_p=dropout_p, seed=seed)
    if impl in ("kernel", "blockwise"):
        return _flash_headmajor(query, key, value, causal, block_size,
                                kv_lens=kv_lens,
                                dropout=(seed, float(dropout_p)))
    mask = None
    if kv_lens is not None:
        mask = (torch.arange(key.shape[1], device=key.device)[None, :]
                < kv_lens[:, None])[:, None, None, :]
    return _sdpa_impl(query, key, value, mask, float(dropout_p), causal,
                      None, seed=seed)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, block_size=512, training=True,
                    name=None, kv_lens=None):
    """paddle.nn.functional.flash_attention-compatible entry.

    Layout [batch, seq, num_heads, head_dim]. Training-mode dropout runs
    inside the CUDA kernels on the card (Philox mask, regenerated in the
    backward) and on the blockwise tier on the CPU; eval mode or
    dropout=0 runs the deterministic forward. kv_lens [b] (int tensor on
    the same device): per-batch true key length for right-padded
    batches. return_softmax is an API-parity flag, as in the JAX
    package: no path returns the probabilities."""
    if dropout and training:
        _fa._check_dropout(dropout)
        return _flash_attention_dropout_op(
            query, key, value, next_seed(query.device), kv_lens,
            causal=causal, dropout_p=float(dropout), block_size=block_size)
    return _flash_attention_op(query, key, value, kv_lens, causal=causal,
                               block_size=block_size)
