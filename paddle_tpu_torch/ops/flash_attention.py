"""Flash attention: the CUDA kernels, their plain versions and autograd.

Counterpart of paddle_tpu/ops/pallas_kernels.py. Its three Pallas TPU
kernels become kernels written by hand for Hopper (sm_90a), built with
nvcc at first use (ops/_build.py) and called through ctypes:

- `_fwd_kernel` -> csrc/flash_attn_fwd.cu (O and lse, with dropout);
- `_dq_kernel` and `_dkv_kernel` -> csrc/flash_attn_bwd.cu (two entries);
- `_drop_mask` -> csrc/philox.cuh, the same generator as ops/philox.py.

Layout [batch, seq, num_heads, head_dim] at every function here, as in
the JAX package.

- flash_attention_fwd(q, k, v, causal, scale, dropout_p, seed) ->
  (O, lse f32 [b, n, sq]) and flash_attention_mha(...) -> O go through
  the torch.autograd.Function _FlashAttention (the `_flash_mha` custom
  VJP). For CUDA tensors the forward and the backward launch the kernels
  or raise; for CPU tensors they run the plain versions. There is no
  fallback from one to the other.
- flash_attention_fwd_plain / flash_attention_bwd_plain: the same math
  in plain PyTorch (blockwise, f32 accumulators, the Philox mask of
  ops/philox.py). The CPU tier and chip_smoke.py use them; the main path
  on a card never does.
- launches counts kernel launches per kernel, so a run can show that its
  main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import philox as _philox

__all__ = ["flash_attention_mha", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_plain",
           "launches", "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"flash_attn_fwd": 0, "flash_attn_bwd_dq": 0,
            "flash_attn_bwd_dkv": 0}

_VP, _I, _LL, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_uint)
# causal, dropout, threshold, seed_lo, seed_hi, rinv, stream
_TAIL = [ctypes.c_float, _I, _I, _U, _U, _U, ctypes.c_float, _VP]
_ARGTYPES = {
    "pt_flash_attn_fwd": [_VP] * 5 + [_I] * 6 + [_LL] * 9 + _TAIL,
    "pt_flash_attn_bwd_dq": [_VP] * 7 + [_I] * 6 + [_LL] * 15 + _TAIL,
    "pt_flash_attn_bwd_dkv": [_VP] * 8 + [_I] * 6 + [_LL] * 18 + _TAIL,
}


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [batch, seq, heads, "
                         f"head_dim] tensors, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, n, h = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != n \
            or k.shape[3] != h:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: batch, heads and head_dim "
                         "must agree, and k and v must match")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v devices differ: {q.device}, {k.device}, "
                         f"{v.device}")


def _check_dropout(dropout_p):
    if not 0.0 <= float(dropout_p) < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")


# ------------------------------------------------------------ plain versions

def _acc_dtype(t):
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None,
                              block_k=512, dropout_p=0.0, seed=0):
    """Plain PyTorch version of the forward kernel: (O, lse f32 [b, n,
    sq]), with attention dropout from the Philox mask when dropout_p >
    0 (l sums the un-dropped probabilities, as in the kernel)."""
    from ..nn.functional.attention import _flash_headmajor
    drop = (int(seed), float(dropout_p)) if dropout_p else None
    return _flash_headmajor(q, k, v, causal, block_k, scale=scale,
                            return_lse=True, dropout=drop)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal=False,
                              scale=None, dropout_p=0.0, seed=0,
                              block_k=256, which="all"):
    """Plain PyTorch version of the two backward kernels: (dq, dk, dv) in
    the input dtype, from the forward's O and lse and O's gradient dO.
    Blockwise over keys with f32 accumulators; P = exp(QK^T*scale - lse)
    recomputed per block, dS = P * (dropout(dP) - rowsum(dO*O)).
    which="dq" or "dkv" computes only the dQ or only the dK/dV kernel's
    outputs (None in place of the others), so each kernel has a plain
    version of its own work."""
    if which not in ("all", "dq", "dkv"):
        raise ValueError(f"which must be all, dq or dkv, got {which!r}")
    want_dq, want_dkv = which in ("all", "dq"), which in ("all", "dkv")
    acc = _acc_dtype(q)
    b, sq, n, h = q.shape
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(h)
    qh, kh, vh, oh, doh = (t.permute(0, 2, 1, 3).to(acc)
                           for t in (q, k, v, o, do))
    lse = lse.to(acc)
    delta = (doh * oh).sum(-1)                        # [b, n, sq]
    dq = torch.zeros_like(qh) if want_dq else None
    dk = torch.empty_like(kh) if want_dkv else None
    dv = torch.empty_like(vh) if want_dkv else None
    from ..nn.functional.attention import _bh_index
    pos_q = torch.arange(sq, device=q.device)
    bh = _bh_index(b, n, q.device)
    rinv = 1.0 / (1.0 - dropout_p) if dropout_p else 1.0
    for j0 in range(0, sk, block_k):
        kj, vj = kh[:, :, j0:j0 + block_k], vh[:, :, j0:j0 + block_k]
        pos_k = j0 + torch.arange(kj.shape[2], device=q.device)
        s = torch.matmul(qh, kj.transpose(-1, -2)) * scale
        valid = pos_k[None, :] < sk
        if causal:
            valid = valid & (pos_q[:, None] >= pos_k[None, :])
        p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
        dp = torch.matmul(doh, vj.transpose(-1, -2))
        pd = p
        if dropout_p:
            keep = _philox.keep_mask(seed, dropout_p, bh, pos_q[:, None],
                                     pos_k[None, :])
            pd = torch.where(keep, p * rinv, 0.0)
            dp = torch.where(keep, dp * rinv, 0.0)
        ds = p * (dp - delta[..., None])
        if want_dkv:
            dv[:, :, j0:j0 + block_k] = torch.matmul(pd.transpose(-1, -2),
                                                     doh)
            dk[:, :, j0:j0 + block_k] = torch.matmul(ds.transpose(-1, -2),
                                                     qh) * scale
        if want_dq:
            dq += torch.matmul(ds, kj) * scale
    return tuple(None if t is None else t.permute(0, 2, 1, 3).to(q.dtype)
                 for t in (dq, dk, dv))


# ------------------------------------------------------------ CUDA kernels

def _aligned16(t):
    """True when every [.., :, .., :] row of t starts on 16 bytes (the
    tensor-core kernels read rows as 16-byte vectors)."""
    per = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s % per == 0 for s in t.stride()[:3]))


def _kernel_input(t):
    """t itself when the kernels can read it through its strides (unit
    head_dim stride; 16-byte rows for bf16), else a contiguous copy."""
    if t.stride(3) == 1 and (t.dtype == torch.float32 or _aligned16(t)):
        return t
    return t.contiguous()


def _check_kernel(name, q, k):
    b, sq, n, h = q.shape
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if h not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"{name} kernel takes head_dim in "
                         f"{SUPPORTED_HEAD_DIMS}, got {h}")
    if sq == 0 or k.shape[1] == 0 or b * n == 0:
        raise ValueError(f"{name}: empty input q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")


def _entry(lib_name, fn_name):
    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[fn_name]
        fn.restype = ctypes.c_int
    return fn


def _strides(*ts):
    return [s for t in ts for s in t.stride()[:3]]


def _tail(q, causal, scale, dropout_p, seed):
    lo, hi = _philox.split_seed(seed)
    rinv = 1.0 / (1.0 - dropout_p) if dropout_p else 1.0
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return [float(scale), int(bool(causal)), int(dropout_p > 0),
            _philox.drop_threshold(dropout_p), lo, hi, rinv, stream]


def _flash_fwd_cuda(q, k, v, causal, scale, dropout_p=0.0, seed=0):
    """Launch csrc/flash_attn_fwd.cu on the current stream."""
    _check_kernel("flash_attn_fwd", q, k)
    b, sq, n, h = q.shape
    sk = k.shape[1]
    q, k, v = (_kernel_input(t) for t in (q, k, v))
    o = torch.empty((b, sq, n, h), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    fn = _entry("flash_attn_fwd", "pt_flash_attn_fwd")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), _KERNEL_DTYPES[q.dtype], b, n, sq, sk, h,
                *_strides(q, k, v), *_tail(q, causal, scale, dropout_p, seed))
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed (code {rc})")
    launches["flash_attn_fwd"] += 1
    return o, lse


def _bwd_delta(o, do):
    """delta = rowsum(dO * O), f32 [b, n, sq]: torch ops, as the JAX
    package leaves it to XLA outside its kernels."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale,
                       dropout_p=0.0, seed=0):
    """Launch the dQ kernel of csrc/flash_attn_bwd.cu: returns dq."""
    _check_kernel("flash_attn_bwd_dq", q, k)
    b, sq, n, h = q.shape
    q, k, v, do = (_kernel_input(t) for t in (q, k, v, do))
    dq = torch.empty((b, sq, n, h), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _entry("flash_attn_bwd", "pt_flash_attn_bwd_dq")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, n, sq, k.shape[1], h,
            *_strides(q, k, v, do, dq),
            *_tail(q, causal, scale, dropout_p, seed))
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd_dq launch failed (code {rc})")
    launches["flash_attn_bwd_dq"] += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale,
                        dropout_p=0.0, seed=0):
    """Launch the dK/dV kernel of csrc/flash_attn_bwd.cu: returns
    (dk, dv)."""
    _check_kernel("flash_attn_bwd_dkv", q, k)
    b, sq, n, h = q.shape
    sk = k.shape[1]
    q, k, v, do = (_kernel_input(t) for t in (q, k, v, do))
    dk = torch.empty((b, sk, n, h), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, n, h), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _entry("flash_attn_bwd", "pt_flash_attn_bwd_dkv")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _KERNEL_DTYPES[q.dtype], b, n, sq, sk, h,
            *_strides(q, k, v, do, dk, dv),
            *_tail(q, causal, scale, dropout_p, seed))
    if rc != 0:
        raise RuntimeError(f"flash_attn_bwd_dkv launch failed (code {rc})")
    launches["flash_attn_bwd_dkv"] += 1
    return dk, dv


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, dropout_p=0.0,
                    seed=0):
    """The backward on the card: delta, then the dQ and the dK/dV
    kernels on the current stream. Returns (dq, dk, dv)."""
    delta = _bwd_delta(o, do)
    lse = lse.contiguous()
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale,
                            dropout_p, seed)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale,
                                 dropout_p, seed)
    return dq, dk, dv


# ------------------------------------------------------------ autograd

def _device_of(t):
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {t.device}")
    return t.device.type


class _FlashAttention(torch.autograd.Function):
    """The `_flash_mha` custom VJP: the forward saves (q, k, v, O, lse)
    and the seed; the backward regenerates the dropout mask from it.
    CUDA tensors launch the kernels, CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_p, seed):
        if _device_of(q) == "cuda":
            o, lse = _flash_fwd_cuda(q, k, v, causal, scale, dropout_p, seed)
        else:
            o, lse = flash_attention_fwd_plain(q, k, v, causal, scale,
                                               dropout_p=dropout_p,
                                               seed=seed)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, dropout_p, seed)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, dropout_p, seed = ctx.args
        if q.device.type == "cuda":
            dq, dk, dv = _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale,
                                         dropout_p, seed)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                   causal, scale,
                                                   dropout_p, seed)
        return dq, dk, dv, None, None, None, None


def flash_attention_fwd(query, key, value, causal=False, scale=None,
                        dropout_p=0.0, seed=None):
    """Flash attention over [b, s, n, h]: returns (O, lse) with O in the
    input dtype and lse f32 [b, n, sq], differentiable in q, k, v.
    scale defaults to 1/sqrt(h). Causal masking is top-left aligned
    (row >= col), as in the Pallas kernel. dropout_p drops attention
    links with the Philox mask of `seed` (0 when None, as the Pallas
    wrapper defaults it)."""
    _check(query, key, value)
    _check_dropout(dropout_p)
    _device_of(query)
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    return _FlashAttention.apply(query, key, value, bool(causal),
                                 float(scale), float(dropout_p),
                                 0 if seed is None else int(seed))


def flash_attention_mha(query, key, value, causal=False, scale=None,
                        dropout_p=0.0, seed=None):
    """Flash attention over [batch, seq, num_heads, head_dim] inputs: the
    output only (pallas_kernels.flash_attention_mha's signature, without
    the TPU interpret flag)."""
    return flash_attention_fwd(query, key, value, causal=causal,
                               scale=scale, dropout_p=dropout_p,
                               seed=seed)[0]
