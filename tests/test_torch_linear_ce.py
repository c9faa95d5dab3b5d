"""The port's F.linear_cross_entropy and cross-entropy options against
the JAX package's.

The same numpy inputs go through paddle_tpu.nn.functional and
paddle_tpu_torch.nn.functional. Tolerances, each for its reason:
- f32 value and gradients (h, w_t, bias) within 1e-5 x max(1, max|ref|):
  the same blockwise math, products and sums in another order
  (tests/conftest.py sets the JAX matmul precision to "highest");
- bf16 within 2e-2 x max(1, max|ref|): the block products round to bf16
  at other places in the two frameworks (torch's addmm adds the bias
  before its one rounding);
- the general cross_entropy / softmax_with_cross_entropy forms within
  1e-5 (both f32 log_softmax compositions).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch.nn.functional import loss as L

N, D = 24, 8


def _close(got, ref, tol):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


def _inputs(v, seed=0):
    rng = np.random.RandomState(seed)
    h = rng.randn(N, D).astype(np.float32)
    w = (rng.randn(D, v) * 0.5).astype(np.float32)
    b = rng.randn(v).astype(np.float32)
    lbl = rng.randint(0, v, N).astype(np.int64)
    lbl[::5] = -100
    return h, w, b, lbl


def _jax(h, w, b, lbl, block, red, dtype="float32"):
    import jax.numpy as jnp
    jt = [paddle.to_tensor(jnp.asarray(a, dtype), stop_gradient=False)
          for a in (h, w, b)]
    out = JF.linear_cross_entropy(jt[0], jt[1], jt[2],
                                  paddle.to_tensor(lbl.astype(np.int32)),
                                  vocab_block=block, reduction=red)
    (out.sum() if red == "none" else out).backward()
    return [np.asarray(out.astype("float32").numpy())] + \
        [np.asarray(t.grad.astype("float32").numpy()) for t in jt]


def _torch(h, w, b, lbl, block, red, dtype=torch.float32):
    tt = [torch.from_numpy(a).to(dtype).requires_grad_(True)
          for a in (h, w, b)]
    out = F.linear_cross_entropy(tt[0], tt[1], tt[2], torch.from_numpy(lbl),
                                 vocab_block=block, reduction=red)
    (out.sum() if red == "none" else out).backward()
    return [out.detach().float().numpy()] + \
        [t.grad.float().numpy() for t in tt]


@pytest.mark.parametrize("red", ["mean", "sum", "none"])
@pytest.mark.parametrize("v,block", [(64, 16), (60, 16), (64, 64)])
def test_linear_ce_f32_matches_jax(v, block, red):
    """Value and the grads of h, w_t and bias, ignored rows included,
    with a vocab a block multiple, a padded one and one block."""
    h, w, b, lbl = _inputs(v)
    ref = _jax(h, w, b, lbl, block, red)
    got = _torch(h, w, b, lbl, block, red)
    for name, g, r in zip(("loss", "dh", "dw", "db"), got, ref):
        assert g.shape == r.shape, name
        _close(g, r, 1e-5)
    if red == "none":
        assert (got[0][::5] == 0).all()


@pytest.mark.parametrize("v,block", [(64, 16), (60, 16)])
def test_linear_ce_bf16_matches_jax(v, block):
    h, w, b, lbl = _inputs(v, seed=1)
    ref = _jax(h, w, b, lbl, block, "mean", dtype="bfloat16")
    got = _torch(h, w, b, lbl, block, "mean", dtype=torch.bfloat16)
    for g, r in zip(got, ref):
        _close(g, r, 2e-2)


def test_linear_ce_equals_dense_ce_without_bias():
    """bias=None (GPT's tied head) against the port's dense CE over the
    materialised logits."""
    h, w, _, lbl = _inputs(60, seed=2)
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    out = F.linear_cross_entropy(th, tw, None, torch.from_numpy(lbl),
                                 vocab_block=16)
    out.backward()
    dh, dw = th.grad.clone(), tw.grad.clone()
    th.grad = tw.grad = None
    ref = F.cross_entropy(th @ tw, torch.from_numpy(lbl))
    ref.backward()
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dh, th.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(dw, tw.grad, atol=1e-5, rtol=1e-5)


def test_linear_ce_saves_nothing_of_n_by_v():
    """No tensor of N x V elements is saved for the backward (the dense
    path, as a check of the check, saves its logits)."""
    v = 64
    h, w, b, lbl = _inputs(v, seed=3)

    def saved_sizes(fn):
        sizes = []

        def pack(t):
            sizes.append(t.numel())
            return t
        th = torch.from_numpy(h).requires_grad_(True)
        tw = torch.from_numpy(w).requires_grad_(True)
        tb = torch.from_numpy(b).requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(th, tw, tb).backward()
        return sizes

    chunked = saved_sizes(lambda th, tw, tb: F.linear_cross_entropy(
        th, tw, tb, torch.from_numpy(lbl), vocab_block=16))
    dense = saved_sizes(lambda th, tw, tb: F.cross_entropy(
        th @ tw + tb, torch.from_numpy(lbl)))
    assert chunked and max(chunked) < N * v
    assert max(dense) >= N * v


@pytest.mark.parametrize("vocab,block,want", [
    (30528, 2048, (15, 30720, 192)),   # ERNIE-base
    (50304, 2048, (25, 51200, 896)),   # GPT-2 small
    (64, 16, (4, 64, 0)), (60, 16, (4, 64, 4))])
def test_vocab_blocks_padding_arithmetic(vocab, block, want):
    assert L._vocab_blocks(vocab, block) == want


# ------------------------------------------------ cross_entropy options

def _ce_inputs(seed=4, n=6, c=5):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, c) * 2).astype(np.float32)
    soft = np.abs(rng.randn(n, c)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    lbl = rng.randint(0, c, n).astype(np.int64)
    lbl[0] = -100
    w = (np.abs(rng.randn(c)) + 0.1).astype(np.float32)
    return x, soft, lbl, w


_CASES = {
    "soft": lambda x, s, l, w: (s, dict(soft_label=True)),
    "soft_float_labels": lambda x, s, l, w: (s, {}),
    "soft_weight_smooth": lambda x, s, l, w: (
        s, dict(soft_label=True, weight=w, label_smoothing=0.1)),
    "weight": lambda x, s, l, w: (l, dict(weight=w)),
    "smoothing": lambda x, s, l, w: (l, dict(label_smoothing=0.1)),
    "weight_smoothing": lambda x, s, l, w: (
        l, dict(weight=w, label_smoothing=0.2)),
    "no_softmax": lambda x, s, l, w: (l, dict(use_softmax=False)),
}


@pytest.mark.parametrize("red", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_cross_entropy_options_match_jax(case, red):
    x, soft, lbl, w = _ce_inputs()
    if case == "no_softmax":
        x = soft.copy()   # probabilities in
    label, kw = _CASES[case](x, soft, lbl, w)
    jkw = {k: paddle.to_tensor(v) if k == "weight" else v
           for k, v in kw.items()}
    jx = paddle.to_tensor(x, stop_gradient=False)
    jl = JF.cross_entropy(jx, paddle.to_tensor(label), reduction=red, **jkw)
    jl.sum().backward()
    tkw = {k: torch.from_numpy(v) if k == "weight" else v
           for k, v in kw.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    tl = F.cross_entropy(tx, torch.from_numpy(label), reduction=red, **tkw)
    tl.sum().backward()
    assert tuple(tl.shape) == tuple(np.shape(jl.numpy()))
    _close(tl.detach().numpy(), jl.numpy(), 1e-5)
    _close(tx.grad.numpy(), jx.grad.numpy(), 1e-5)


@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy_return_softmax_matches_jax(soft):
    x, sl, lbl, _ = _ce_inputs(seed=5)
    label = sl if soft else lbl[:, None]
    jl, jsm = JF.softmax_with_cross_entropy(
        paddle.to_tensor(x), paddle.to_tensor(label), soft_label=soft,
        return_softmax=True)
    tl, tsm = F.softmax_with_cross_entropy(
        torch.from_numpy(x), torch.from_numpy(label), soft_label=soft,
        return_softmax=True)
    assert tl.shape == (6, 1) and tsm.shape == (6, 5)
    _close(tl.numpy(), jl.numpy(), 1e-5)
    _close(tsm.numpy(), jsm.numpy(), 1e-5)
    one = F.softmax_with_cross_entropy(torch.from_numpy(x),
                                       torch.from_numpy(label),
                                       soft_label=soft)
    torch.testing.assert_close(one, tl)


def test_cross_entropy_other_axis_still_raises():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(NotImplementedError, match="last axis"):
        F.cross_entropy(x, torch.zeros(2, 4, dtype=torch.long), axis=1)


def test_softmax_with_cross_entropy_is_black_listed_under_o1():
    """An AMP black-list op in both packages: under O1 bf16 logits are
    cast to f32, so the returned softmax is f32."""
    import jax.numpy as jnp
    from paddle_tpu_torch import amp
    x, _, lbl, _ = _ce_inputs(seed=7)
    jx = paddle.to_tensor(jnp.asarray(x, jnp.bfloat16))
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        _, jsm = JF.softmax_with_cross_entropy(
            jx, paddle.to_tensor(lbl[:, None]), return_softmax=True)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        _, tsm = F.softmax_with_cross_entropy(
            torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(lbl[:, None]), return_softmax=True)
    assert str(jsm.dtype).endswith("float32") and tsm.dtype == torch.float32
    _close(tsm.numpy(), jsm.numpy(), 1e-5)
