"""The port's flash-attention backward against the JAX package's.

paddle_tpu_torch.ops.flash_attention's autograd Function runs, for CPU
tensors, the plain versions of the forward and of the two backward
kernels (flash_attention_bwd_plain). Here its gradients are held against
jax.grad of paddle_tpu.ops.pallas_kernels.flash_attention_mha in Pallas
interpret mode, which runs the `_dq_kernel`/`_dkv_kernel` code, on the
same numpy inputs at the shapes of tests/test_pallas_attention.py.

Tolerances: dq/dk/dv at atol=rtol=1e-4 in float32. Both sides compute in
f32 (tests/conftest.py sets the JAX matmul precision to "highest") and
differ in summation order: the Pallas kernels sum over 128-row blocks,
the plain version over 256-key blocks. The dropout mask is pinned by
gradcheck in float64 (the Pallas interpreter stubs its RNG to zeros, so
dropout is never compared bit for bit with JAX).

The CUDA kernels run only on a card: the `cuda`-marked tests hold them
against the plain versions there (chip_smoke.py does the same at the
main path's shapes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     load_jax_params)
from paddle_tpu_torch.ops import flash_attention as fa
from test_pallas_attention import CASES

TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """tier-1 runs several pytest workers on one CPU: torch's default
    thread pool then oversubscribes it and its small ops slow down 20x
    or more, so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(b, sq, sk, n, h, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, n, h).astype(np.float32)
    k = rng.randn(b, sk, n, h).astype(np.float32)
    v = rng.randn(b, sk, n, h).astype(np.float32)
    w = rng.randn(b, sq, n, h).astype(np.float32)  # output cotangent
    return q, k, v, w


def _jax_grads(q, k, v, w, causal):
    def f(q_, k_, v_):
        o = pk.flash_attention_mha(q_, k_, v_, causal=causal, interpret=True)
        return jnp.sum(o * jnp.asarray(w))
    g = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v))
    return [np.asarray(x) for x in g]


def _torch_grads(q, k, v, w, causal, **kw):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = fa.flash_attention_mha(*ts, causal=causal, **kw)
    (o * torch.from_numpy(w)).sum().backward()
    return [t.grad.numpy() for t in ts]


def _check(q, k, v, w, causal):
    before = dict(fa.launches)
    got = _torch_grads(q, k, v, w, causal)
    # CPU tensors never reach a kernel
    assert fa.launches == before
    for name, a, b in zip("qkv", got, _jax_grads(q, k, v, w, causal)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,n,h,_case_causal", CASES)
def test_grads_match_pallas_interpret(b, s, n, h, _case_causal, causal):
    _check(*_data(b, s, s, n, h), causal)


@pytest.mark.parametrize("causal", [False, True])
def test_cross_attention_grads(causal):
    # kv seq != q seq; causal stays top-left (row >= col)
    _check(*_data(2, 64, 192, 2, 64, seed=1), causal)


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_gradcheck_float64(p):
    """Analytic (plain backward) against numeric gradients in float64;
    at p = 0.3 the backward must regenerate the forward's mask."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 12, 2, 4), generator=g, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))

    def f(q_, k_, v_):
        return fa.flash_attention_mha(q_, k_, v_, causal=True, dropout_p=p,
                                      seed=1234)
    assert torch.autograd.gradcheck(f, (q, k, v), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_plain_backward_per_kernel_parts(p):
    """which="dq"/"dkv" give exactly the dQ or the dK/dV kernel's part of
    the whole plain backward (each kernel's own plain version)."""
    q, k, v, w = (torch.from_numpy(a) for a in _data(2, 20, 24, 2, 8))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, True, 0.3,
                                          dropout_p=p, seed=7)
    args = (q, k, v, o, lse, w, True, 0.3, p, 7)
    dq, dk, dv = fa.flash_attention_bwd_plain(*args, block_k=8)
    dq_only = fa.flash_attention_bwd_plain(*args, block_k=8, which="dq")
    dkv_only = fa.flash_attention_bwd_plain(*args, block_k=8, which="dkv")
    assert dq_only[1] is None and dq_only[2] is None and dkv_only[0] is None
    assert torch.equal(dq_only[0], dq)
    assert torch.equal(dkv_only[1], dk) and torch.equal(dkv_only[2], dv)
    with pytest.raises(ValueError, match="which"):
        fa.flash_attention_bwd_plain(*args, which="dk")


def test_outputs_carry_the_function_grad_fn():
    """Every flash call goes through the named op's autograd formula
    (the fault of slice 1: the kernel's outputs were cut off from
    autograd)."""
    q, k, v, _ = (torch.from_numpy(a).requires_grad_(True)
                  for a in _data(1, 16, 16, 2, 8))
    name = "GeneratedBackwardFor_paddle_tpu_flash_attn_fwd_defaultBackward"
    o, lse = fa.flash_attention_fwd(q, k, v)
    assert type(o.grad_fn).__name__ == name
    assert not lse.requires_grad
    o2 = fa.flash_attention_mha(q, k, v, dropout_p=0.2, seed=5)
    assert type(o2.grad_fn).__name__ == name


def _tiny(use_flash):
    cfg = ErnieConfig.tiny(hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0,
                           use_flash_attention=use_flash)
    pt.seed(0)
    return ErnieForPretraining(cfg, device="cpu").train()


def test_train_mode_qkv_grad_matches_sdpa_route():
    """A tiny ERNIE in train() with dropout 0: the flash route's
    qkv.weight gradient is non-zero and equals the SDPA route's."""
    flash, sdpa = _tiny(True), _tiny(False)
    sdpa.load_state_dict(flash.state_dict())
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 1024, (2, 24)))
    lbl = torch.from_numpy(rng.randint(0, 1024, (2, 24)))
    grads = []
    for m in (flash, sdpa):
        loss = ErnieForPretraining.pretraining_loss(m(ids), lbl)
        loss.backward()
        grads.append(m.ernie.encoder[0].attention.qkv.weight.grad)
    assert grads[0].abs().max() > 0
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=1e-5)


def test_model_grads_match_jax_in_train_mode():
    """The tiny ERNIE's gradients (dropout 0, train mode) against the JAX
    model's, carried over by name."""
    import paddle_tpu as paddle
    from paddle_tpu.models import ErnieConfig as JC
    from paddle_tpu.models import ErnieForPretraining as JE
    cfg = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    paddle.seed(0)
    jm = JE(JC.tiny(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ErnieForPretraining(ErnieConfig.tiny(**cfg), device="cpu").train()
    load_jax_params(tm, state)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 1024, (2, 32)).astype(np.int64)
    lbl = rng.randint(0, 1024, (2, 32)).astype(np.int64)
    jloss = JE.pretraining_loss(jm(paddle.to_tensor(ids)),
                                paddle.to_tensor(lbl))
    jloss.backward()
    tloss = ErnieForPretraining.pretraining_loss(tm(torch.from_numpy(ids)),
                                                 torch.from_numpy(lbl))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()),
                               rtol=1e-5)
    jp = dict(jm.named_parameters())
    for name in ("ernie.encoder.0.attention.qkv.weight",
                 "ernie.encoder.1.ffn_in.weight",
                 "ernie.embeddings.word_embeddings.weight", "mlm_bias"):
        tg = dict(tm.named_parameters())[name].grad.numpy()
        np.testing.assert_allclose(tg, np.asarray(jp[name].grad.numpy()),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


def _bf16(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def _odd_offset():
    # packed, but one element into its storage: 2 bytes off 16
    return _bf16(1 + 2 * 16 * 2 * 64)[1:].view(2, 16, 2, 64)


@pytest.mark.parametrize("make,copied", [
    (lambda: _bf16(2, 16, 3, 2, 64)[:, :, 1], False),       # fused qkv view
    (lambda: _bf16(2, 16, 2, 64), False),                   # packed
    (lambda: _bf16(1, 16, 2, 64)[:1], False),               # batch of 1
    (lambda: _bf16(2, 16, 1, 64).expand(2, 16, 2, 64), True),  # heads 0
    (_odd_offset, True),                                    # base not 16 B
    (lambda: _bf16(2, 16, 2, 68)[..., :64], True),          # 136-byte rows
    (lambda: _bf16(2, 2, 16, 64).transpose(1, 2), True),    # heads outside
    (lambda: _bf16(2, 16, 2, 128)[..., ::2], True),         # h stride 2
])
def test_kernel_input_copies_what_tma_cannot_read(make, copied):
    """The bf16 kernels read q, k, v, O and dO by TMA: a view whose base
    or strides are not whole 16-byte multiples, or whose heads lie
    outside its rows, is copied into fresh packed memory; the fused qkv
    views and packed tensors go in as they are."""
    t = make()
    got = fa._kernel_input(t)
    assert (got.data_ptr() != t.data_ptr()) == copied
    assert torch.equal(got, t)
    assert fa._tma_ok(got)


def _f32(*shape, seed=0):
    return _bf16(*shape, seed=seed).float()


@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("make,copied", [
    (lambda h: _f32(2, 16, 3, 2, h)[:, :, 1], False),         # qkv view
    (lambda h: _f32(2, 16, 2, h), False),                     # packed
    (lambda h: _f32(1 + 2 * 16 * 2 * h)[1:].view(2, 16, 2, h),
     True),                                                   # base 4 B off
    (lambda h: _f32(2, 16, 2, h + 2)[..., :h], True),         # rows 8 B off
    (lambda h: _f32(2, 2, 16, h).transpose(1, 2), True),      # heads out
    (lambda h: _f32(2, 16, 2, 2 * h)[..., ::2], True),        # h stride 2
])
def test_kernel_input_f32_copies_what_bulk_copies_cannot_read(h, make,
                                                              copied):
    """The f32 kernels at 64 and 128 (the forward fwd_ffma, the backward
    dq_ffma and dkv_ffma) copy whole 16-byte rows by the bulk copy engine
    (and the dQ kernel reads O and dO as float4 rows): a view whose base
    or row strides are not 16-byte multiples, or whose heads lie outside
    its rows, is copied; the fused qkv views and packed tensors go in as
    they are."""
    t = make(h)
    got = fa._kernel_input(t)
    assert (got.data_ptr() != t.data_ptr()) == copied
    assert torch.equal(got, t) and fa._tma_ok(got)


def test_tma_strides_give_size_one_dims_a_packed_stride():
    t = _bf16(1, 8, 3, 1, 64)[:, :, 0]          # b 1, n 1: strides unused
    assert fa._tma_strides(t) == (8 * 3 * 64, 3 * 64, 64)
    qkv = _bf16(2, 8, 3, 4, 64)
    assert fa._tma_strides(qkv[:, :, 2]) == (8 * 3 * 4 * 64, 3 * 4 * 64, 64)


def _record_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(fa, "_launch",
                        lambda lib, fn, q, args: calls.append((fn, args)))
    return calls


def test_bf16_backward_computes_delta_in_the_dq_kernel(monkeypatch):
    """bf16: no torch op computes delta; the dQ kernel gets O and a fresh
    f32 [b, n, sq] buffer, and the dK/dV kernel reads that buffer."""
    calls = _record_launches(monkeypatch)
    monkeypatch.setattr(fa, "_bwd_delta", lambda o, do: pytest.fail(
        "delta computed by torch ops on the bf16 path"))
    qkv = _bf16(2, 24, 3, 2, 64)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, do = _bf16(2, 24, 2, 64, seed=1), _bf16(2, 24, 2, 64, seed=2)
    lse = torch.zeros((2, 2, 24))
    before = dict(fa.launches)
    dq, dk, dv = fa._flash_bwd_cuda(q, k, v, o, lse, do, False, 0.125)
    assert [c[0] for c in calls] == ["pt_flash_attn_bwd_dq",
                                     "pt_flash_attn_bwd_dkv"]
    dq_args, dkv_args = calls[0][1], calls[1][1]
    # q, k, v (the fused views, uncopied), O, dO, lse, delta, dq
    assert dq_args[:5] == [q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           o.data_ptr(), do.data_ptr()]
    assert dq_args[7] == dq.data_ptr() and dq_args[8] == 1
    assert dkv_args[5] == dq_args[6]  # the dQ kernel's delta buffer
    assert fa.launches["flash_attn_bwd_dq"] == before["flash_attn_bwd_dq"] + 1
    assert fa.launches["flash_attn_bwd_dkv"] == \
        before["flash_attn_bwd_dkv"] + 1


@pytest.mark.parametrize("h", [64, 128, 256, 512])
def test_f32_backward_computes_delta_in_the_dq_kernel(monkeypatch, h):
    """f32 at every head_dim (csrc/flash_attn_bwd.cu's dq_ffma and
    dkv_ffma at 64 and 128, csrc/flash_attn_wide.cu's kernels from 256):
    no torch op computes delta; the dQ entry gets O and a fresh f32 [b,
    n, sq] buffer, and the dK/dV entry reads that buffer."""
    calls = _record_launches(monkeypatch)
    monkeypatch.setattr(fa, "_bwd_delta", lambda o, do: pytest.fail(
        f"delta computed by torch ops in f32 at head_dim {h}"))
    q, k, v, o, do = (_bf16(1, 16, 2, h, seed=i).float() for i in range(5))
    fa._flash_bwd_cuda(q, k, v, o, torch.zeros((1, 2, 16)), do, True, 0.125)
    tail = "_wide" if h >= 256 else ""
    assert [c[0] for c in calls] == ["pt_flash_attn_bwd_dq" + tail,
                                     "pt_flash_attn_bwd_dkv" + tail]
    dq_args, dkv_args = calls[0][1], calls[1][1]
    assert dq_args[3] == o.data_ptr() and dq_args[8] == dkv_args[8] == 0
    assert dkv_args[5] == dq_args[6]  # the dQ kernel's delta buffer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,causal,p", [(512, False, 0.0), (200, True, 0.0),
                                        (200, False, 0.1)])
def test_backward_kernels_match_plain_on_card(cuda_device, dtype, tol, s,
                                              causal, p):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((2, s, 3, 4, 64), generator=g,
                      device=cuda_device).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn((2, s, 4, 64), generator=g, device=cuda_device).to(dtype)
    o, lse = fa._flash_fwd_cuda(q, k, v, causal, 0.125, p, 9)
    before = dict(fa.launches)
    got = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal, 0.125, p, 9)
    assert fa.launches["flash_attn_bwd_dq"] == before["flash_attn_bwd_dq"] + 1
    assert fa.launches["flash_attn_bwd_dkv"] == before["flash_attn_bwd_dkv"] + 1
    ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal, 0.125,
                                       p, 9)
    for a, b in zip(got, ref):
        bound = tol * max(1.0, b.float().abs().max().item())
        assert (a.float() - b.float()).abs().max().item() <= bound
