"""Flash attention: the CUDA kernels, their plain versions and autograd.

Counterpart of paddle_tpu/ops/pallas_kernels.py. Its three Pallas TPU
kernels become kernels written by hand for Hopper (sm_90a), built with
nvcc at first use (ops/_build.py) and called through ctypes:

- `_fwd_kernel` -> csrc/flash_attn_fwd.cu (O and lse, with dropout);
- `_dq_kernel` and `_dkv_kernel` -> csrc/flash_attn_bwd.cu (two entries,
  the dQ one computing delta too);
- in bf16 all three are wgmma kernels fed by TMA, on one pipeline
  (csrc/flash_wgmma.cuh); in f32 exact FFMA kernels;
- `_drop_mask` -> csrc/philox.cuh, the same generator as ops/philox.py.

Layout [batch, seq, num_heads, head_dim] at every function here, as in
the JAX package.

- flash_attention_fwd(q, k, v, causal, scale, dropout_p, seed) ->
  (O, lse f32 [b, n, sq]) and flash_attention_mha(...) -> O go through
  the torch.autograd.Function _FlashAttention (the `_flash_mha` custom
  VJP). The dropout seed is data, as `_flash_mha(q, k, v, seed, ...)`
  takes it: a 0-d int64 tensor on the inputs' device (an int becomes
  one without a host sync), whose two 32-bit words the kernels read
  from device memory at their start. So a captured CUDA graph draws a
  new mask whenever the step writes a new seed into that tensor, and
  the backward reads the same tensor as the forward (kept in ctx).
  For CUDA tensors the forward and the backward launch the kernels or
  raise; for CPU tensors they run the plain versions. There is no
  fallback from one to the other. The kernels take head_dim 64 and
  128; on the card a smaller head_dim runs zero-padded up to the
  next of them (kernel_head_dim), as the Pallas wrapper pads to 128.
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

from ..core.generator import seed_tensor
from . import _build
from . import philox as _philox

__all__ = ["flash_attention_mha", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_plain",
           "launches", "SUPPORTED_HEAD_DIMS", "kernel_head_dim"]

SUPPORTED_HEAD_DIMS = (64, 128)
# the devices whose head_dim flash_attention_fwd pads to kernel_head_dim
# (the kernels'; the CPU's plain version takes any head_dim)
_PADDED_ON = ("cuda",)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"flash_attn_fwd": 0, "flash_attn_bwd_dq": 0,
            "flash_attn_bwd_dkv": 0}

_VP, _I, _LL, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_uint)
# scale, causal, dropout, threshold, seed (device pointer), rinv, stream
_TAIL = [ctypes.c_float, _I, _I, _U, _VP, ctypes.c_float, _VP]
_ARGTYPES = {
    "pt_flash_attn_fwd": [_VP] * 5 + [_I] * 6 + [_LL] * 9 + _TAIL,
    "pt_flash_attn_bwd_dq": [_VP] * 8 + [_I] * 6 + [_LL] * 18 + _TAIL,
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
    0 (l sums the un-dropped probabilities, as in the kernel). seed is
    taken as the kernel takes it, a 0-d int64 tensor (an int or a Draw
    is turned into one)."""
    from ..nn.functional.attention import _flash_headmajor
    seed_t = _seed_arg(seed, dropout_p, q.device)
    drop = (seed_t, float(dropout_p)) if dropout_p else None
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
    version of its own work. seed as in flash_attention_fwd_plain."""
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
    seed = _seed_arg(seed, dropout_p, q.device)
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

def _tma_strides(t):
    """(batch, seq, head) element strides of a [b, s, n, h] tensor as the
    kernels are given them: a dimension of size 1 takes the stride a
    packed tensor would give it (its own stride is never used, and the
    bf16 backward's tensor maps must describe a layout)."""
    b, s, n, h = t.shape
    sb, ss, sn, _ = t.stride()
    sn = sn if n > 1 else h
    ss = ss if s > 1 else sn * n
    sb = sb if b > 1 else ss * s
    return sb, ss, sn


def _tma_ok(t):
    """True when the bf16 kernels can read t in place: a unit head_dim
    stride, a 16-byte-aligned base, strides of whole 16-byte multiples
    (TMA's rule; cp.async and ldmatrix read 16-byte rows), and head, seq
    and batch laid out in that order without overlap, as the fused qkv
    views and every packed tensor are."""
    if t.stride(3) != 1 or t.data_ptr() % 16:
        return False
    _, s, n, h = t.shape
    sb, ss, sn = _tma_strides(t)
    per = 16 // t.element_size()
    return (all(x % per == 0 for x in (sb, ss, sn))
            and sn >= h and ss >= sn * n and sb >= ss * s)


def _kernel_input(t):
    """t itself when the kernels can read it through its strides (a unit
    head_dim stride in f32; _tma_ok in bf16), else a packed copy in fresh
    (aligned) memory."""
    ok = t.stride(3) == 1 if t.dtype == torch.float32 else _tma_ok(t)
    return t if ok else t.clone(memory_format=torch.contiguous_format)


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


def _launch(lib_name, fn_name, q, args):
    """Call the C entry fn_name of csrc/<lib_name>.cu with args and the
    current stream of q's card; raise if the launch was refused."""
    with torch.cuda.device(q.device):
        rc = _entry(lib_name, fn_name)(
            *args, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed (code {rc})")


def _strides(*ts):
    return [s for t in ts for s in _tma_strides(t)]


def _seed_arg(seed, dropout_p, device):
    """The seed as the kernels take it: a 0-d int64 tensor on `device`
    when dropout_p > 0 (seed_tensor: an int becomes one without a host
    sync), else None (the kernels read no seed)."""
    if not dropout_p:
        return None
    return seed_tensor(0 if seed is None else seed, device)


def _tail(causal, scale, dropout_p, seed_t):
    """The launch arguments after the strides; seed_t from _seed_arg
    (its data pointer is what the kernels read the key from)."""
    rinv = 1.0 / (1.0 - dropout_p) if dropout_p else 1.0
    return [float(scale), int(bool(causal)), int(dropout_p > 0),
            _philox.drop_threshold(dropout_p),
            None if seed_t is None else seed_t.data_ptr(), rinv]


def _flash_fwd_cuda(q, k, v, causal, scale, dropout_p=0.0, seed=0):
    """Launch csrc/flash_attn_fwd.cu on the current stream."""
    _check_kernel("flash_attn_fwd", q, k)
    b, sq, n, h = q.shape
    sk = k.shape[1]
    q, k, v = (_kernel_input(t) for t in (q, k, v))
    seed_t = _seed_arg(seed, dropout_p, q.device)
    o = torch.empty((b, sq, n, h), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    _launch("flash_attn_fwd", "pt_flash_attn_fwd", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), _KERNEL_DTYPES[q.dtype], b, n, sq, sk, h,
             *_strides(q, k, v), *_tail(causal, scale, dropout_p, seed_t)])
    launches["flash_attn_fwd"] += 1
    return o, lse


def _bwd_delta(o, do):
    """delta = rowsum(dO * O), f32 [b, n, sq]: torch ops, as the JAX
    package leaves it to XLA outside its kernels. The f32 backward uses
    it; the bf16 dQ kernel computes delta itself."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _delta_in_kernel(dtype):
    """True when the dQ kernel computes delta for this dtype: the dQ
    entry's delta buffer is then its output (bf16, dq_wgmma), else its
    input, filled by _bwd_delta (f32, dq_simt). csrc/flash_attn_bwd.cu's
    launch_dq picks the kernel by the same dtype rule."""
    return dtype == torch.bfloat16


def _flash_bwd_dq_cuda(q, k, v, o, do, lse, causal, scale, dropout_p=0.0,
                       seed=0):
    """Launch the dQ kernel of csrc/flash_attn_bwd.cu: returns (dq,
    delta), delta = rowsum(dO * O) f32 [b, n, sq], which the dK/dV
    kernel reads. In bf16 the kernel computes delta and writes it."""
    _check_kernel("flash_attn_bwd_dq", q, k)
    b, sq, n, h = q.shape
    q, k, v, o, do = (_kernel_input(t) for t in (q, k, v, o, do))
    seed_t = _seed_arg(seed, dropout_p, q.device)
    lse = lse.contiguous()
    if _delta_in_kernel(q.dtype):
        delta = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    else:
        delta = _bwd_delta(o, do)
    dq = torch.empty((b, sq, n, h), dtype=q.dtype, device=q.device)
    _launch("flash_attn_bwd", "pt_flash_attn_bwd_dq", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             _KERNEL_DTYPES[q.dtype], b, n, sq, k.shape[1], h,
             *_strides(q, k, v, o, do, dq),
             *_tail(causal, scale, dropout_p, seed_t)])
    launches["flash_attn_bwd_dq"] += 1
    return dq, delta


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale,
                        dropout_p=0.0, seed=0):
    """Launch the dK/dV kernel of csrc/flash_attn_bwd.cu: returns
    (dk, dv)."""
    _check_kernel("flash_attn_bwd_dkv", q, k)
    b, sq, n, h = q.shape
    sk = k.shape[1]
    q, k, v, do = (_kernel_input(t) for t in (q, k, v, do))
    seed_t = _seed_arg(seed, dropout_p, q.device)
    lse = lse.contiguous()
    dk = torch.empty((b, sk, n, h), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, sk, n, h), dtype=q.dtype, device=q.device)
    _launch("flash_attn_bwd", "pt_flash_attn_bwd_dkv", q,
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             _KERNEL_DTYPES[q.dtype], b, n, sq, sk, h,
             *_strides(q, k, v, do, dk, dv),
             *_tail(causal, scale, dropout_p, seed_t)])
    launches["flash_attn_bwd_dkv"] += 1
    return dk, dv


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale, dropout_p=0.0,
                    seed=0):
    """The backward on the card: the dQ kernel (with delta), then the
    dK/dV kernel on the current stream. Returns (dq, dk, dv)."""
    seed = _seed_arg(seed, dropout_p, q.device)
    dq, delta = _flash_bwd_dq_cuda(q, k, v, o, do, lse, causal, scale,
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
    and the seed tensor (None at p 0); the backward regenerates the
    dropout mask from that same tensor. CUDA tensors launch the kernels,
    CPU tensors run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, dropout_p, seed):
        if _device_of(q) == "cuda":
            o, lse = _flash_fwd_cuda(q, k, v, causal, scale, dropout_p, seed)
        else:
            o, lse = flash_attention_fwd_plain(q, k, v, causal, scale,
                                               dropout_p=dropout_p,
                                               seed=seed)
        ctx.save_for_backward(q, k, v, o, lse, seed)
        ctx.args = (causal, scale, dropout_p)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, seed = ctx.saved_tensors
        causal, scale, dropout_p = ctx.args
        if q.device.type == "cuda":
            dq, dk, dv = _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale,
                                         dropout_p, seed)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                   causal, scale,
                                                   dropout_p, seed)
        return dq, dk, dv, None, None, None, None


def kernel_head_dim(h):
    """The head_dim the kernels run h at: the smallest of
    SUPPORTED_HEAD_DIMS that holds h, or h itself above them (the
    kernels then refuse it)."""
    return next((d for d in SUPPORTED_HEAD_DIMS if d >= h), h)


def flash_attention_fwd(query, key, value, causal=False, scale=None,
                        dropout_p=0.0, seed=None):
    """Flash attention over [b, s, n, h]: returns (O, lse) with O in the
    input dtype and lse f32 [b, n, sq], differentiable in q, k, v.
    scale defaults to 1/sqrt(h). On the card a head_dim below 128 that
    the kernels lack runs zero-padded to kernel_head_dim(h), the output
    sliced back; the CPU's plain version takes any h. Causal masking is top-left aligned
    (row >= col), as in the Pallas kernel. dropout_p drops attention
    links with the Philox mask of `seed` (0 when None, as the Pallas
    wrapper defaults it): an int, a 0-d int64 tensor, or a Draw of a
    captured step (core/generator.py seed_tensor)."""
    _check(query, key, value)
    _check_dropout(dropout_p)
    h = query.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(h)
    hp = kernel_head_dim(h) if _device_of(query) in _PADDED_ON else h
    if hp != h:
        # zero columns are exact no-ops for QK^T, PV and the three
        # gradients (the Pallas wrapper pads to 128 lanes the same way);
        # pad's backward slices them off the gradients
        query, key, value = (torch.nn.functional.pad(t, (0, hp - h))
                             for t in (query, key, value))
    o, lse = _FlashAttention.apply(query, key, value, bool(causal),
                                   float(scale), float(dropout_p),
                                   _seed_arg(seed, dropout_p, query.device))
    return (o[..., :h] if hp != h else o), lse


def flash_attention_mha(query, key, value, causal=False, scale=None,
                        dropout_p=0.0, seed=None):
    """Flash attention over [batch, seq, num_heads, head_dim] inputs: the
    output only (pallas_kernels.flash_attention_mha's signature, without
    the TPU interpret flag)."""
    return flash_attention_fwd(query, key, value, causal=causal,
                               scale=scale, dropout_p=dropout_p,
                               seed=seed)[0]
