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
                                          (256, False, 128, 0.0)])
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
    assert [fa.kernel_head_dim(h) for h in (8, 32, 64, 65, 96, 128, 256)] \
        == [64, 64, 64, 128, 128, 128, 256]


@pytest.mark.parametrize("h,causal,p", [(8, False, 0.0), (32, True, 0.1),
                                        (96, False, 0.1)])
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
