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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,causal", [(512, False), (200, True)])
def test_kernel_matches_plain_on_card(cuda_device, dtype, tol, s, causal):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((2, s, 3, 4, 64), generator=g,
                      device=cuda_device).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = fa.launches["flash_attn_fwd"]
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    assert fa.launches["flash_attn_fwd"] == before + 1
    o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_ref, atol=tol, rtol=tol)
