"""Flash-attention forward: the CUDA kernel and its plain version.

Counterpart of paddle_tpu/ops/pallas_kernels.py. The Pallas TPU kernel
`_fwd_kernel` becomes paddle_tpu_torch/csrc/flash_attn_fwd.cu, written
by hand for Hopper (sm_90a), built with nvcc at first use (ops/_build.py)
and called through ctypes. Layout [batch, seq, num_heads, head_dim] at
every function here, as in the JAX package.

- flash_attention_fwd(q, k, v, causal, scale) -> (O, lse f32 [b, n, sq]).
  For CUDA tensors it launches the kernel or raises; for CPU tensors it
  runs the plain version. There is no fallback from one to the other.
- flash_attention_fwd_plain: the plain PyTorch version, the blockwise
  online softmax of nn/functional/attention.py with lse. The CPU tests
  use it and chip_smoke.py holds the kernel against it on the card.
- launches["flash_attn_fwd"] counts kernel launches, so a run can show
  that its main path went through the kernel.

The dQ and dK/dV backward kernels and the in-kernel dropout RNG belong
to the training slice: dropout_p > 0 raises NotImplementedError.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention_mha", "flash_attention_fwd",
           "flash_attention_fwd_plain", "launches", "SUPPORTED_HEAD_DIMS"]

SUPPORTED_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"flash_attn_fwd": 0}


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


def flash_attention_fwd_plain(q, k, v, causal=False, scale=None,
                              block_k=512):
    """Plain PyTorch version of the kernel: (O, lse f32 [b, n, sq])."""
    from ..nn.functional.attention import _flash_headmajor
    return _flash_headmajor(q, k, v, causal, block_k, scale=scale,
                            return_lse=True)


def _aligned16(t):
    """True when every [.., :, .., :] row of t starts on 16 bytes (the
    tensor-core kernel reads rows as 16-byte vectors)."""
    per = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0
            and all(s % per == 0 for s in t.stride()[:3]))


def _flash_fwd_cuda(q, k, v, causal, scale):
    """Launch csrc/flash_attn_fwd.cu on the current stream."""
    b, sq, n, h = q.shape
    sk = k.shape[1]
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash_attn_fwd kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if h not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd kernel takes head_dim in "
                         f"{SUPPORTED_HEAD_DIMS}, got {h}")
    if sq == 0 or sk == 0 or b * n == 0:
        raise ValueError(f"flash_attn_fwd: empty input q {tuple(q.shape)},"
                         f" k {tuple(k.shape)}")
    # Strided views (qkv[:, :, i]) are read in place; only a unit
    # head_dim stride is required, and 16-byte rows for bf16. Anything
    # else is copied contiguous first.
    q, k, v = (t if t.stride(3) == 1 and (t.dtype == torch.float32
                                         or _aligned16(t))
               else t.contiguous() for t in (q, k, v))
    o = torch.empty((b, sq, n, h), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attn_fwd")
    fn = lib.pt_flash_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), _KERNEL_DTYPES[q.dtype], b, n, sq, sk, h,
                q.stride(0), q.stride(1), q.stride(2),
                k.stride(0), k.stride(1), k.stride(2),
                v.stride(0), v.stride(1), v.stride(2),
                float(scale), int(bool(causal)), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed (code {rc})")
    launches["flash_attn_fwd"] += 1
    return o, lse


def flash_attention_fwd(query, key, value, causal=False, scale=None,
                        dropout_p=0.0):
    """Flash attention over [b, s, n, h]: returns (O, lse) with O in the
    input dtype and lse f32 [b, n, sq]. scale defaults to 1/sqrt(h).
    Causal masking is top-left aligned (row >= col), as in the Pallas
    kernel."""
    if dropout_p:
        raise NotImplementedError(
            "training slice: in-kernel attention dropout is not ported yet")
    _check(query, key, value)
    if scale is None:
        scale = 1.0 / math.sqrt(query.shape[-1])
    if query.device.type == "cpu":
        return flash_attention_fwd_plain(query, key, value, causal, scale)
    if query.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, "
                         f"got {query.device}")
    return _flash_fwd_cuda(query, key, value, causal, scale)


def flash_attention_mha(query, key, value, causal=False, scale=None):
    """Flash attention over [batch, seq, num_heads, head_dim] inputs:
    the output only (pallas_kernels.flash_attention_mha's signature,
    without the TPU interpret flag and without dropout)."""
    return flash_attention_fwd(query, key, value, causal=causal,
                               scale=scale)[0]
