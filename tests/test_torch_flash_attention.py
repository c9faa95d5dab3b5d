"""The port's flash-attention forward against the JAX package's.

paddle_tpu_torch.ops.flash_attention on CPU tensors runs its plain
version (the blockwise online softmax); its CUDA kernel cannot run on a
machine without a card, and is held against the same plain version on
the card by chip_smoke.py and by the `cuda`-marked test below. Here the
plain version is held against paddle_tpu.ops.pallas_kernels'
flash_attention_mha run in Pallas interpret mode, on the same numpy
inputs, at the shapes of tests/test_pallas_attention.py.

Tolerances: O at atol=rtol=1e-4 in float32 (tests/conftest.py sets the
JAX matmul precision to "highest", so both sides are f32 and differ only
in summation order); lse at 1e-4 against a float64 numpy log-sum-exp of
the materialised logits.
"""
import ctypes
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch.nn.functional as TF
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import flash_attention as fa
from test_pallas_attention import CASES

TOL = 1e-4


def _data(b, sq, sk, n, h, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, n, h).astype(np.float32)
    k = rng.randn(b, sk, n, h).astype(np.float32)
    v = rng.randn(b, sk, n, h).astype(np.float32)
    return q, k, v


def _lse_ref(q, k, causal):
    """float64 log-sum-exp of the scaled logits, [b, n, sq]."""
    q64, k64 = q.astype(np.float64), k.astype(np.float64)
    logits = np.einsum("bqnh,bknh->bnqk", q64, k64) / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = logits.shape[-2:]
        keep = np.arange(sq)[:, None] >= np.arange(sk)[None, :]
        logits = np.where(keep, logits, -np.inf)
    mx = logits.max(-1, keepdims=True)
    return (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]


def _check(q, k, v, causal):
    ref = np.asarray(pk.flash_attention_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))
    before = fa.launches["flash_attn_fwd"]
    o, lse = fa.flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    # a CPU tensor never reaches the kernel
    assert fa.launches["flash_attn_fwd"] == before
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    assert tuple(lse.shape) == (q.shape[0], q.shape[2], q.shape[1])
    np.testing.assert_allclose(o.numpy(), ref, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), _lse_ref(q, k, causal),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,n,h,_case_causal", CASES)
def test_forward_matches_pallas_interpret(b, s, n, h, _case_causal, causal):
    _check(*_data(b, s, s, n, h), causal)


def test_cross_attention_shapes():
    # kv seq != q seq, as test_pallas_attention.test_cross_attention_shapes
    _check(*_data(2, 64, 192, 2, 64, seed=1), False)


def test_mha_returns_output_only():
    q, k, v = (torch.from_numpy(a) for a in _data(1, 40, 40, 2, 16))
    o = fa.flash_attention_mha(q, k, v, causal=True)
    o2, _ = fa.flash_attention_fwd(q, k, v, causal=True)
    assert torch.equal(o, o2)


def test_explicit_scale_matches_pallas():
    q, k, v = _data(1, 48, 48, 2, 32, seed=2)
    ref = np.asarray(pk.flash_attention_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3,
        interpret=True))
    o = fa.flash_attention_mha(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), scale=0.3)
    np.testing.assert_allclose(o.numpy(), ref, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_functional_matches_jax_functional(causal):
    """F.flash_attention of the port against the JAX F.flash_attention
    (which on the CPU takes its blockwise lax.scan path)."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    q, k, v = _data(2, 96, 96, 3, 32, seed=3)
    ref = JF.flash_attention(paddle.to_tensor(q), paddle.to_tensor(k),
                             paddle.to_tensor(v), causal=causal,
                             training=False).numpy()
    out = TF.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal,
                             training=False)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_functional_kv_lens_matches_jax():
    """kv_lens (right-padded batches) takes the blockwise path in both
    packages; block_size smaller than s exercises the carry."""
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    q, k, v = _data(3, 72, 72, 2, 16, seed=4)
    lens = np.array([72, 40, 7], np.int32)
    ref = JF.flash_attention(paddle.to_tensor(q), paddle.to_tensor(k),
                             paddle.to_tensor(v), training=False,
                             block_size=32,
                             kv_lens=paddle.to_tensor(lens)).numpy()
    out = TF.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), training=False,
                             block_size=32,
                             kv_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_sdpa_matches_jax_sdpa_with_additive_mask():
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    q, k, v = _data(2, 24, 24, 2, 8, seed=5)
    mask = np.where(np.random.RandomState(6).rand(2, 1, 1, 24) > 0.3,
                    0.0, -1e9).astype(np.float32)
    ref = JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=paddle.to_tensor(mask), training=False).numpy()
    out = TF.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        attn_mask=torch.from_numpy(mask), training=False)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL, rtol=TOL)


def test_training_dropout_raises():
    """Training-mode dropout runs (the training slice ported it); what
    still raises is a rate outside [0, 1)."""
    q, k, v = (torch.from_numpy(a) for a in _data(1, 16, 16, 2, 8))
    with pytest.raises(ValueError, match="dropout_p"):
        fa.flash_attention_fwd(q, k, v, dropout_p=1.0)
    with pytest.raises(ValueError, match="dropout_p"):
        TF.flash_attention(q, k, v, dropout=1.5, training=True)
    ev = TF.flash_attention(q, k, v, dropout=0.1, training=False)
    tr = TF.flash_attention(q, k, v, dropout=0.5, training=True)
    sd = TF.scaled_dot_product_attention(q, k, v, dropout_p=0.5)
    assert torch.isfinite(tr).all() and torch.isfinite(sd).all()
    assert (tr - ev).abs().max() > 1e-3
    # eval mode ignores the rate, as in the JAX package
    torch.testing.assert_close(ev, TF.flash_attention(q, k, v,
                                                      training=False))


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _data(1, 16, 16, 2, 8))
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k[:, :, :1], v)
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q, k.double(), v)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q[0], k[0], v[0])


def _bf16(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def _record_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(fa, "_launch",
                        lambda lib, fn, q, args: calls.append((lib, fn, args)))
    return calls


@pytest.mark.parametrize("causal,p", [(False, 0.0), (True, 0.1)])
def test_bf16_forward_launches_the_wgmma_entry_on_fused_views(monkeypatch,
                                                             causal, p):
    """bf16 on fused qkv views: one call of pt_flash_attn_fwd with the
    views' own pointers and strides (no copy), O [b, sq, n, h] in bf16
    and lse f32 [b, n, sq] allocated by the wrapper, and the launch
    counted. The argument layout is the C entry's: 5 pointers, dtype, b,
    n, sq, sk, h, 9 strides, then scale, causal, dropout, threshold,
    the pointer to the seed's two 32-bit words in device memory (None
    at p 0: no seed is read) and 1 / (1 - p)."""
    calls = []

    def launch(lib, fn, q, args):
        ptr = args[24]
        words = None if ptr is None else \
            list((ctypes.c_uint32 * 2).from_address(ptr))
        calls.append((lib, fn, args, words))
    monkeypatch.setattr(fa, "_launch", launch)
    b, s, n, h = 2, 40, 3, 64
    qkv = _bf16(b, s, 3, n, h)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = fa.launches["flash_attn_fwd"]
    o, lse = fa._flash_fwd_cuda(q, k, v, causal, 0.125, p, 7)
    assert fa.launches["flash_attn_fwd"] == before + 1
    assert len(calls) == 1
    lib, fn, args, words = calls[0]
    assert (lib, fn) == ("flash_attn_fwd", "pt_flash_attn_fwd")
    assert args[:5] == [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr()]
    assert args[5:11] == [1, b, n, s, s, h]
    fused = [s * 3 * n * h, 3 * n * h, h]
    assert args[11:20] == fused * 3
    assert args[20:23] == [0.125, int(causal), int(p > 0)]
    assert args[23] == (int(p * 2 ** 32) if p else 0)
    assert words == ([7, 0] if p else None)
    assert args[25] == pytest.approx(1 / (1 - p))
    assert len(args) + 1 == len(fa._ARGTYPES["pt_flash_attn_fwd"])
    assert o.shape == (b, s, n, h) and o.dtype == torch.bfloat16
    assert o.is_contiguous()
    assert lse.shape == (b, n, s) and lse.dtype == torch.float32


def test_bf16_forward_copies_only_what_tma_cannot_read(monkeypatch):
    """A view whose heads lie outside its rows goes in as a packed copy;
    the other two inputs, fused views, go in as they are."""
    calls = _record_launches(monkeypatch)
    qkv = _bf16(1, 16, 3, 2, 64)
    q = _bf16(1, 2, 16, 64).transpose(1, 2)       # heads outside rows
    k, v = qkv[:, :, 1], qkv[:, :, 2]
    fa._flash_fwd_cuda(q, k, v, False, 0.125)
    args = calls[0][2]
    assert args[0] != q.data_ptr()
    assert args[1:3] == [k.data_ptr(), v.data_ptr()]
    assert args[11:14] == [16 * 2 * 64, 2 * 64, 64]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,causal,h,p", [(512, False, 64, 0.0),
                                          (200, True, 64, 0.0),
                                          (512, False, 64, 0.1),
                                          (200, True, 128, 0.1),
                                          (256, False, 128, 0.0),
                                          (200, True, 256, 0.1),
                                          (256, False, 256, 0.0),
                                          (200, True, 320, 0.1),
                                          (256, False, 512, 0.0),
                                          (128, True, 1024, 0.1)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, tol, s, causal,
                                      h, p):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((2, s, 3, 4, h), generator=g,
                      device=cuda_device).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = fa.launches["flash_attn_fwd"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, dropout_p=p,
                                    seed=5)
    assert fa.launches["flash_attn_fwd"] == before + 1
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                  dropout_p=p, seed=5)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=tol, rtol=tol)


def test_kernel_head_dim_pads_to_the_smallest_kernel_width():
    assert [fa.kernel_head_dim(h)
            for h in (8, 32, 64, 65, 96, 128, 129, 192, 256, 320, 512,
                      1024)] \
        == [64, 64, 64, 128, 128, 128, 256, 256, 256, 512, 512, 1024]


@pytest.mark.parametrize("h,want", [(512, (2, 1)), (768, (3, 1)),
                                    (1024, (4, 1)), (2048, (8, 1)),
                                    (2304, (5, 2)), (4096, (8, 2)),
                                    (4352, (6, 3))])
def test_wide_cluster_covers_every_chunk_in_a_portable_cluster(h, want):
    """The f32 dQ and dK/dV above 256 run the h / 256 chunk CTAs of a row
    block as one cluster of at most 8 (the portable size): every chunk
    owned by exactly one CTA, no CTA without one, and the fewest chunks
    a CTA that fit (csrc/flash_attn_wide.cu's cluster_of)."""
    size, per = fa.wide_cluster(h)
    nc = h // 256
    assert (size, per) == want
    assert size <= 8 and (size - 1) * per < nc <= size * per
    assert per == -(-nc // 8)


def _f32_odd_offset(h):
    # packed, but one element into its storage: 4 bytes off 16
    return torch.randn(1 + 2 * 8 * 2 * h)[1:].view(2, 8, 2, h)


@pytest.mark.parametrize("make,copied", [
    (lambda: torch.randn(2, 8, 3, 2, 512)[:, :, 1], False),  # fused qkv view
    (lambda: torch.randn(2, 8, 2, 512), False),              # packed
    (lambda: _f32_odd_offset(512), True),                    # base not 16 B
    (lambda: torch.randn(2, 8, 2, 513)[..., :512], True),    # rows not 16 B
    (lambda: _f32_odd_offset(256), False),                   # at 256: as is
])
def test_f32_kernel_input_above_256_is_16_byte_aligned(make, copied):
    """Above head_dim 256 the f32 backward copies whole 16-byte rows into
    shared memory (csrc/flash_attn_wide.cu refuses any other): a view
    whose base or strides are not whole 16-byte multiples is copied into
    fresh packed memory; up to 256 the f32 kernels read any view with a
    unit head_dim stride as it is."""
    t = make()
    got = fa._kernel_input(t, "pt_flash_attn_bwd_dq")
    assert (got.data_ptr() != t.data_ptr()) == copied
    assert torch.equal(got, t)
    if t.shape[3] > 256:
        assert fa._tma_ok(got)


@pytest.mark.parametrize("make,copied", [
    (lambda: torch.randn(2, 8, 3, 2, 256)[:, :, 1], False),  # fused qkv view
    (lambda: torch.randn(2, 8, 2, 256), False),              # packed
    (lambda: _f32_odd_offset(256), True),                    # base not 16 B
    (lambda: torch.randn(2, 8, 2, 257)[..., :256], True),    # rows not 16 B
    (lambda: _f32_odd_offset(128), False),                   # below 256
])
def test_f32_forward_input_from_256_is_16_byte_aligned(make, copied):
    """From head_dim 256 the f32 forward (csrc/flash_attn_wide.cu's
    cluster forward, at 256 too) copies whole 16-byte rows into shared
    memory: a view whose base or strides are not whole 16-byte multiples
    is copied into fresh packed memory; below 256 the f32 forward reads
    any view with a unit head_dim stride as it is."""
    t = make()
    got = fa._kernel_input(t, "pt_flash_attn_fwd")
    assert (got.data_ptr() != t.data_ptr()) == copied
    assert torch.equal(got, t)
    if t.shape[3] >= 256:
        assert fa._tma_ok(got)


@pytest.mark.parametrize("fn,h,dtype,want", [
    ("pt_flash_attn_fwd", 256, torch.float32, (1, 1)),
    ("pt_flash_attn_bwd_dq", 256, torch.float32, None),
    ("pt_flash_attn_bwd_dkv", 256, torch.float32, None),
    ("pt_flash_attn_fwd", 256, torch.bfloat16, None),
    ("pt_flash_attn_fwd", 128, torch.float32, None),
    ("pt_flash_attn_fwd", 1024, torch.float32, (4, 1)),
    ("pt_flash_attn_bwd_dkv", 2304, torch.float32, (5, 2)),
    ("pt_flash_attn_bwd_dq", 1024, torch.bfloat16, None),
])
def test_kernel_cluster_follows_the_kernel_entry(fn, h, dtype, want):
    """The cluster a kernel runs in follows _kernel_entry: the f32
    kernels of csrc/flash_attn_wide.cu run wide_cluster's (the forward a
    cluster of one at 256), every other kernel none."""
    assert fa.kernel_cluster(fn, h, dtype) == want
    in_wide = fa._kernel_entry(None, fn, h, dtype)[0] == "flash_attn_wide"
    assert in_wide == (want is not None)


@pytest.mark.parametrize("h", [256, 320, 64])
def test_wide_cluster_refuses_widths_the_wide_kernels_lack(h):
    with pytest.raises(ValueError, match="head_dim"):
        fa.wide_cluster(h)


@pytest.mark.parametrize("h", [320, 512, 1024, 2304])
@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_above_256_matches_pallas_interpret(h, causal):
    """Above head_dim 256 (csrc/flash_attn_wide.cu on the card, padded to
    a multiple of 256), the plain path the CPU runs: O and lse against
    the Pallas kernel in interpret mode (which pads to a multiple of
    128), and dQ, dK, dV against jax.grad of it, at 1e-4 in f32."""
    from test_torch_flash_backward import _check as _check_grads
    q, k, v = _data(2, 24, 40, 2, h, seed=11)
    _check(q, k, v, causal)
    w = np.random.RandomState(12).randn(2, 24, 2, h).astype(np.float32)
    _check_grads(q, k, v, w, causal)


def test_head_dim_above_256_refuses_widths_the_wide_kernels_lack():
    """The wide kernels take multiples of 256 above 256: another width
    reaches them only through the padding of flash_attention_fwd, and
    the wrappers' check raises before any launch."""
    q = torch.zeros(1, 4, 2, 320)
    with pytest.raises(ValueError, match="head_dim"):
        fa._check_kernel("flash_attn_fwd", q, q)
    fa._check_kernel("flash_attn_fwd", torch.zeros(1, 4, 2, 768),
                     torch.zeros(1, 4, 2, 768))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_above_256_launches_the_wide_entries(monkeypatch, dtype):
    """Above 256 the wrappers call entries with the arguments of the
    others: in bf16 the three entries of csrc/flash_attn_wgwide.cu (the
    wgmma kernels), in f32 the three of csrc/flash_attn_wide.cu; in both
    the dQ entry computes delta itself (its buffer is the dK/dV
    entry's)."""
    calls = _record_launches(monkeypatch)
    monkeypatch.setattr(fa, "_bwd_delta", lambda o, do: pytest.fail(
        "delta computed by torch ops above head_dim 256"))
    q, k, v = (torch.randn(1, 8, 2, 512).to(dtype) for _ in range(3))
    o, lse = fa._flash_fwd_cuda(q, k, v, False, 0.05)
    fa._flash_bwd_cuda(q, k, v, o, lse, torch.randn_like(o), False, 0.05)
    src, tail = (("flash_attn_wgwide", "_wgwide") if dtype == torch.bfloat16
                 else ("flash_attn_wide", "_wide"))
    assert [c[:2] for c in calls] == [
        (src, "pt_flash_attn_fwd" + tail),
        (src, "pt_flash_attn_bwd_dq" + tail),
        (src, "pt_flash_attn_bwd_dkv" + tail)]
    assert [len(c[2]) + 1 for c in calls] == [
        len(fa._ARGTYPES[c[1]]) for c in calls]
    assert calls[1][2][6] == calls[2][2][5]   # the dQ entry's delta
    assert fa._delta_in_kernel(dtype, 512)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_head_dim_768_matches_pallas_interpret(causal):
    """bf16 at head_dim 768 (three 256-wide chunks, an odd count, on the
    card's csrc/flash_attn_wgwide.cu), cross-attention with ragged
    lengths (sq 40, sk 24), the plain path the CPU runs on bf16 tensors:
    O against the Pallas kernel in interpret mode and dQ, dK, dV against
    jax.grad of it, both on the same bf16-rounded inputs in f32.
    Tolerance: 2e-2 of each output's largest magnitude (chip_smoke.py's
    bf16 TOL); the port computes in f32 and rounds its outputs to bf16
    (2^-9 relative)."""
    from test_torch_flash_backward import _jax_grads
    q, k, v = _data(2, 40, 24, 2, 768, seed=21)
    w = np.random.RandomState(22).randn(2, 40, 2, 768).astype(np.float32)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, w)]
    q, k, v, w = (t.float().numpy() for t in bf)
    want = [np.asarray(pk.flash_attention_mha(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        interpret=True))] + _jax_grads(q, k, v, w, causal)
    ts = [t.requires_grad_(True) for t in bf[:3]]
    before = dict(fa.launches)
    o = fa.flash_attention_mha(*ts, causal=causal)
    (o.float() * bf[3].float()).sum().backward()
    assert fa.launches == before
    for name, got, ref in zip(("o", "dq", "dk", "dv"),
                              [o] + [t.grad for t in ts], want):
        assert got.dtype == torch.bfloat16, name
        np.testing.assert_allclose(got.detach().float().numpy(), ref,
                                   atol=2e-2 * np.abs(ref).max(), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_dim_256_launches_the_d256_entries(monkeypatch, dtype):
    """At head_dim 256 the wrappers call entries with the arguments of
    the others: in bf16 the three entries of csrc/flash_attn_wg256.cu
    (the wgmma kernels; the dQ entry computes delta, and its delta buffer
    is the one the dK/dV entry reads); in f32 the forward entry of
    csrc/flash_attn_wide.cu (its cluster forward, a cluster of one CTA
    at 256) and the two backward entries of csrc/flash_attn_d256.cu, the
    dQ entry reading delta from torch ops."""
    calls = _record_launches(monkeypatch)
    if dtype == torch.bfloat16:
        monkeypatch.setattr(fa, "_bwd_delta", lambda o, do: pytest.fail(
            "delta computed by torch ops in bf16 at head_dim 256"))
    q, k, v = (torch.randn(1, 8, 2, 256).to(dtype) for _ in range(3))
    o, lse = fa._flash_fwd_cuda(q, k, v, True, 0.0625)
    fa._flash_bwd_cuda(q, k, v, o, lse, torch.randn_like(o), True, 0.0625)
    src, tail = (("flash_attn_wg256", "_wg256") if dtype == torch.bfloat16
                 else ("flash_attn_d256", "_d256"))
    fwd = ((src, "pt_flash_attn_fwd" + tail) if dtype == torch.bfloat16
           else ("flash_attn_wide", "pt_flash_attn_fwd_wide"))
    assert [c[:2] for c in calls] == [
        fwd,
        (src, "pt_flash_attn_bwd_dq" + tail),
        (src, "pt_flash_attn_bwd_dkv" + tail)]
    assert [len(c[2]) + 1 for c in calls] == [
        len(fa._ARGTYPES[c[1]]) for c in calls]
    assert calls[1][2][6] == calls[2][2][5]   # the dQ entry's delta
    assert calls[0][2][5] == calls[1][2][8] == calls[2][2][8] \
        == fa._KERNEL_DTYPES[dtype]
    assert fa._delta_in_kernel(dtype, 256) == (dtype == torch.bfloat16)
    assert fa._delta_in_kernel(torch.bfloat16, 128)


@pytest.mark.parametrize("h,causal,p", [(8, False, 0.0), (32, True, 0.1),
                                        (96, False, 0.1), (192, True, 0.1),
                                        (256, False, 0.1)])
def test_padded_head_dim_equals_unpadded(monkeypatch, h, causal, p):
    """The card's padding of head_dim (zero columns up to
    kernel_head_dim), run on the plain version: O, lse and the three
    gradients equal the unpadded run's at 1e-5, with the scale of the
    original head_dim."""
    q0, k0, v0 = _data(2, 24, 20, 2, h, seed=8)
    w = torch.from_numpy(np.random.RandomState(9).randn(2, 24, 2, h)
                         .astype(np.float32))

    def run():
        q, k, v = (torch.from_numpy(a).requires_grad_()
                   for a in (q0, k0, v0))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        dropout_p=p, seed=3)
        (o * w).sum().backward()
        return [o.detach(), lse, q.grad, k.grad, v.grad]

    ref = run()
    widths = []
    plain = fa.flash_attention_fwd_plain

    def spy(q, *a, **kw):
        widths.append(q.shape[-1])
        return plain(q, *a, **kw)
    monkeypatch.setattr(fa, "_PADDED_ON", ("cuda", "cpu"))
    monkeypatch.setattr(fa, "flash_attention_fwd_plain", spy)
    got = run()
    assert widths == [fa.kernel_head_dim(h)]
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in ref]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_head_dim_32_runs_padded_on_card(cuda_device, dtype, tol):
    """A head_dim the kernels lack (32, as nn.Transformer(256, 8) has)
    runs on them zero-padded to 64: O and the gradients against the
    plain version at head_dim 32."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((2, 96, 4, 32), generator=g,
                           device=cuda_device).to(dtype).requires_grad_()
               for _ in range(3))
    do = torch.randn((2, 96, 4, 32), generator=g,
                     device=cuda_device).to(dtype)
    before = dict(fa.launches)
    o, lse = fa.flash_attention_fwd(q, k, v, dropout_p=0.1, seed=5)
    o.backward(do)
    assert all(fa.launches[n] > before[n] for n in fa.launches)
    scale = 1.0 / math.sqrt(32)
    o_ref, lse_ref = fa.flash_attention_fwd_plain(
        q.detach(), k.detach(), v.detach(), False, scale, dropout_p=0.1,
        seed=5)
    grads = fa.flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), o_ref, lse_ref, do, False,
        scale, 0.1, 5)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=tol, rtol=tol)
    for got, want in zip((q.grad, k.grad, v.grad), grads):
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
