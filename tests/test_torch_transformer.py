"""The port's Transformer layers against the JAX package's:
MultiHeadAttention (self, cross with sq != sk, masked, need_weights;
incremental Cache decoding against the full causal pass, and
StaticCache), the encoder and decoder layers and stacks in pre- and
post-norm, nn.Transformer, and a tiny translation model (chip_smoke.py's
mt_model at MT_TINY: vocab 97, d_model 32, 4 heads, 2 + 2 layers, FFN
64, batch 3, source 12, target 9) trained 4 TrainStep steps in f32 at
dropout 0 against the JAX TrainStep.

Weights carry across by name (load_jax_params); the same numpy inputs
go through both. Forward values and the gradients of sum(out * w) (with
respect to the inputs and every parameter) at 1e-5 x max(1, |ref|) for
one attention (f32 products and reductions in another order), 5e-5 for
a layer or a stack of them (each layer's LayerNorm statistics, softmax
sums and products add their own rounding to what reaches the first
layer's weights); the TrainStep losses at 1e-5 relative (as tests/test_torch_training.py holds ERNIE's),
the trained parameters at 1e-3 absolute, learning rates about 2e-3
(Adam's steps are about the learning rate wherever sqrt(v) ~ eps, and a
ReLU unit whose input sits at 0 for some token can take its step in one
package and not the other), all but the key projections' biases: their gradient is zero in exact
arithmetic (softmax is invariant to a shift shared by a row's logits),
so each package's is its own rounding noise, which Adam at epsilon 1e-9
turns into steps of about the learning rate.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn as tnn
from paddle_tpu.static import TrainStep as JaxTrainStep
from paddle_tpu_torch.models import load_jax_params
from paddle_tpu_torch.static import TrainStep
from torch_ops_parity import close

TOL = 1e-5
STACK_TOL = 5e-5
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke_mt",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _leaves(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _leaves(v)]
    return [x]


def _pair(jlayer, tlayer):
    state = {k: np.asarray(v.numpy()) for k, v in
             jlayer.state_dict().items()}
    load_jax_params(tlayer, state)
    jlayer.eval()
    tlayer.eval()
    return jlayer, tlayer


def _compare(jlayer, tlayer, arrays, consts=(), tol=TOL, **kw):
    """Both layers on the float `arrays` (taking gradients) and the
    `consts` (masks: no gradient), forward and the gradients of
    sum(out * w), at `tol`."""
    jlayer, tlayer = _pair(jlayer, tlayer)
    jx = [jp.to_tensor(a, stop_gradient=False) for a in arrays]
    tx = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    jc = [None if c is None else jp.to_tensor(c) for c in consts]
    tc = [None if c is None else torch.from_numpy(np.array(c))
          for c in consts]
    jo = _leaves(jlayer(*jx, *jc, **kw))
    to = _leaves(tlayer(*tx, *tc, **kw))
    rng = np.random.RandomState(5)
    ws = [rng.randn(*o.shape).astype(np.float32) for o in jo]
    sum(jp.sum(o * jp.to_tensor(w)) for o, w in zip(jo, ws)).backward()
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(to, ws)).backward()
    assert len(to) == len(jo)
    for i, (a, b) in enumerate(zip(to, jo)):
        close(a.detach().numpy(), np.asarray(b.numpy()), tol, f"out[{i}]")
    for i, (a, b) in enumerate(zip(tx, jx)):
        close(a.grad.numpy(), np.asarray(b.grad.numpy()), tol, f"grad[{i}]")
    jp_ = dict(jlayer.named_parameters())
    tp_ = dict(tlayer.named_parameters())
    assert sorted(tp_) == sorted(jp_)
    for k in jp_:
        g = jp_[k].grad
        want = np.zeros(jp_[k].shape, np.float32) if g is None \
            else np.asarray(g.numpy())
        got = tp_[k].grad
        got = np.zeros(want.shape, np.float32) if got is None \
            else got.numpy()
        close(got, want, tol, f"grad {k}")
    return to


def _causal(n):
    return np.where(np.tril(np.ones((n, n), bool)), 0.0,
                    -np.inf).astype(np.float32)


# -- MultiHeadAttention --------------------------------------------------------

@pytest.mark.parametrize("form", ["self", "cross", "cross-longer-q",
                                  "kdim-vdim"])
def test_mha_matches_jax(form):
    jp.seed(0)
    kw = dict(kdim=12, vdim=20) if form == "kdim-vdim" else {}
    j = jnn.MultiHeadAttention(16, 4, **kw)
    t = tnn.MultiHeadAttention(16, 4, **kw)
    q = _x(2, 7, 16, seed=1)
    if form == "self":
        arrays = [q]
    elif form == "cross":
        arrays = [q, _x(2, 11, 16, seed=2), _x(2, 11, 16, seed=3)]
    elif form == "cross-longer-q":
        arrays = [_x(2, 11, 16, seed=1), _x(2, 5, 16, seed=2),
                  _x(2, 5, 16, seed=3)]
    else:
        arrays = [q, _x(2, 9, 12, seed=2), _x(2, 9, 20, seed=3)]
    _compare(j, t, arrays)


@pytest.mark.parametrize("mask", ["causal", "bool", "batch"])
def test_mha_masked_matches_jax(mask):
    jp.seed(1)
    j = jnn.MultiHeadAttention(16, 4)
    t = tnn.MultiHeadAttention(16, 4)
    x = _x(2, 6, 16, seed=4)
    if mask == "causal":
        m = _causal(6)
    elif mask == "bool":
        m = np.random.RandomState(6).rand(6, 6) > 0.3
        m[:, 0] = True
    else:
        m = np.random.RandomState(7).randn(2, 1, 6, 6).astype(np.float32)
    _compare(j, t, [x, x, x], consts=[m])


def test_mha_need_weights_takes_sdpa_and_returns_no_weights():
    """need_weights=True forces the SDPA route but returns only the
    output (the JAX layer's quirk, followed)."""
    jp.seed(2)
    j = jnn.MultiHeadAttention(16, 4, need_weights=True)
    t = tnn.MultiHeadAttention(16, 4, need_weights=True)
    from paddle_tpu_torch.nn import functional as F
    calls = []
    real = F.scaled_dot_product_attention
    F.scaled_dot_product_attention = lambda *a, **k: (calls.append(1),
                                                      real(*a, **k))[1]
    try:
        out = _compare(j, t, [_x(2, 5, 16, seed=8)])
    finally:
        F.scaled_dot_product_attention = real
    assert len(out) == 1 and calls == [1]


def test_mha_incremental_cache_equals_the_full_causal_pass():
    """Feeding a sequence one token at a time through Cache (each query
    sees the keys so far; the flash route, no mask) equals the full pass
    under the causal mask (the SDPA route), in the port and in the JAX
    package, and the two packages agree."""
    jp.seed(3)
    j = jnn.MultiHeadAttention(16, 4)
    t = tnn.MultiHeadAttention(16, 4)
    j, t = _pair(j, t)
    x = _x(2, 6, 16, seed=9)
    tx = torch.from_numpy(x)
    full = t(tx, tx, tx, torch.from_numpy(_causal(6)))
    cache = t.gen_cache(tx)
    assert isinstance(cache, t.Cache) and cache.k.shape == (2, 0, 4, 4)
    steps = []
    for i in range(6):
        out, cache = t(tx[:, i:i + 1], cache=cache)
        steps.append(out)
    inc = torch.cat(steps, 1)
    close(inc.detach().numpy(), full.detach().numpy(), TOL, "incremental")
    jx = jp.to_tensor(x)
    jcache = j.gen_cache(jx)
    jsteps = []
    for i in range(6):
        out, jcache = j(jx[:, i:i + 1], cache=jcache)
        jsteps.append(np.asarray(out.numpy()))
    close(inc.detach().numpy(), np.concatenate(jsteps, 1), TOL, "vs jax")
    assert cache.k.shape == (2, 6, 4, 4)


def test_mha_static_cache_matches_jax():
    jp.seed(4)
    j = jnn.MultiHeadAttention(16, 4)
    t = tnn.MultiHeadAttention(16, 4)
    j, t = _pair(j, t)
    q, mem = _x(2, 3, 16, seed=10), _x(2, 8, 16, seed=11)
    tc = t.gen_cache(torch.from_numpy(mem), type=t.StaticCache)
    jc = j.gen_cache(jp.to_tensor(mem), type=j.StaticCache)
    got = t(torch.from_numpy(q), cache=tc)
    want = j(jp.to_tensor(q), cache=jc)
    close(got.detach().numpy(), np.asarray(want.numpy()), TOL, "static")
    plain = t(torch.from_numpy(q), torch.from_numpy(mem),
              torch.from_numpy(mem))
    close(got.detach().numpy(), plain.detach().numpy(), TOL, "plain")


# -- encoder and decoder layers, stacks, Transformer ----------------------------

@pytest.mark.parametrize("pre_norm", [False, True])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_encoder_layer_and_stack_match_jax(pre_norm, act):
    jp.seed(5)
    args = (16, 4, 32)
    kw = dict(dropout=0.0, activation=act, normalize_before=pre_norm)
    jl = jnn.TransformerEncoderLayer(*args, **kw)
    tl = tnn.TransformerEncoderLayer(*args, **kw)
    x = _x(2, 7, 16, seed=12)
    _compare(jl, tl, [x], tol=STACK_TOL)
    jp.seed(6)
    j = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(*args, **kw), 2,
                               jnn.LayerNorm(16) if pre_norm else None)
    t = tnn.TransformerEncoder(tnn.TransformerEncoderLayer(*args, **kw), 2,
                               tnn.LayerNorm(16) if pre_norm else None)
    _compare(j, t, [x], consts=[_causal(7)], tol=STACK_TOL)


@pytest.mark.parametrize("pre_norm", [False, True])
def test_decoder_layer_and_stack_match_jax(pre_norm):
    jp.seed(7)
    args = (16, 4, 32)
    kw = dict(dropout=0.0, normalize_before=pre_norm)
    tgt, mem = _x(2, 5, 16, seed=13), _x(2, 9, 16, seed=14)
    jl = jnn.TransformerDecoderLayer(*args, **kw)
    tl = tnn.TransformerDecoderLayer(*args, **kw)
    _compare(jl, tl, [tgt, mem], consts=[_causal(5)], tol=STACK_TOL)
    jp.seed(8)
    j = jnn.TransformerDecoder(jnn.TransformerDecoderLayer(*args, **kw), 3)
    t = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(*args, **kw), 3)
    _compare(j, t, [tgt, mem], consts=[_causal(5)], tol=STACK_TOL)


def test_decoder_cache_steps_match_the_full_pass():
    """TransformerDecoder.gen_cache (incremental self-attention caches
    and static cross-attention caches per layer) stepped token by token
    equals the full causal pass."""
    jp.seed(9)
    t = tnn.TransformerDecoder(tnn.TransformerDecoderLayer(
        16, 4, 32, dropout=0.0), 2).eval()
    tgt = torch.from_numpy(_x(2, 5, 16, seed=15))
    mem = torch.from_numpy(_x(2, 9, 16, seed=16))
    full = t(tgt, mem, torch.from_numpy(_causal(5)))
    cache = t.gen_cache(mem)
    outs = []
    for i in range(5):
        out, cache = t(tgt[:, i:i + 1], mem, cache=cache)
        outs.append(out)
    close(torch.cat(outs, 1).detach().numpy(), full.detach().numpy(), TOL,
          "decoder cache")


@pytest.mark.parametrize("pre_norm", [False, True])
def test_transformer_matches_jax(pre_norm):
    jp.seed(10)
    kw = dict(d_model=16, nhead=4, num_encoder_layers=2,
              num_decoder_layers=2, dim_feedforward=32, dropout=0.0,
              normalize_before=pre_norm)
    j = jnn.Transformer(**kw)
    t = tnn.Transformer(**kw)
    src, tgt = _x(2, 8, 16, seed=17), _x(2, 6, 16, seed=18)
    mask = t.generate_square_subsequent_mask(6)
    close(mask.numpy(),
          np.asarray(jnn.Transformer.generate_square_subsequent_mask(6)
                     .numpy()), 0.0, "mask")
    _compare(j, t, [src, tgt], consts=[None, _causal(6)], tol=STACK_TOL)


def test_clone_layer_keeps_the_reference_quirk():
    """Layers 2..N are rebuilt without attn_dropout, act_dropout,
    weight_attr or bias_attr, in both packages."""
    for nn_ in (jnn, tnn):
        enc = nn_.TransformerEncoder(nn_.TransformerEncoderLayer(
            16, 4, 32, dropout=0.1, attn_dropout=0.3, act_dropout=0.2), 3)
        first, later = enc.layers[0], enc.layers[2]
        assert first.self_attn.dropout == 0.3 and first.act_dropout.p == 0.2
        assert later.self_attn.dropout == 0.1 and later.act_dropout.p == 0.1


def test_mha_takes_the_flash_route_only_without_a_mask():
    from paddle_tpu_torch.nn import functional as F
    t = tnn.MultiHeadAttention(16, 4)
    x = torch.from_numpy(_x(2, 5, 16, seed=19))
    seen = []
    real = {n: getattr(F, n) for n in ("flash_attention",
                                       "scaled_dot_product_attention")}
    for n, fn in real.items():
        setattr(F, n, lambda *a, _n=n, _f=fn, **k: (seen.append(_n),
                                                    _f(*a, **k))[1])
    try:
        t(x)
        t(x, x, x, torch.from_numpy(_causal(5)))
        tnn.MultiHeadAttention(16, 4, use_flash=False)(x)
    finally:
        for n, fn in real.items():
            setattr(F, n, fn)
    assert seen == ["flash_attention", "scaled_dot_product_attention",
                    "scaled_dot_product_attention"]


# -- the tiny translation model: 4 TrainStep steps against JAX ------------------

def test_tiny_mt_trainstep_matches_jax(cs):
    vocab, (b, s, t) = 97, (3, 12, 9)
    jp.seed(11)
    jm = cs.mt_model(jp, vocab, s, **cs.MT_TINY)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = cs.mt_model(pt, vocab, s, **cs.MT_TINY)
    load_jax_params(tm, state)
    n_params = sum(int(np.prod(p.shape)) for p in tm.parameters())
    assert n_params == sum(int(np.prod(p.shape))
                           for p in jm.parameters())
    jopt, jsched = cs.mt_optimizer(jp, 32, 4, learning_rate=0.1)
    topt, tsched = cs.mt_optimizer(pt, 32, 4, learning_rate=0.1)
    jstep = JaxTrainStep(jm, cs.mt_loss(jp, vocab), jopt)
    tstep = TrainStep(tm, cs.mt_loss(pt, vocab), topt)
    src, tin, tout = cs.mt_batch(np, b, s, t, vocab)
    jl, tl = [], []
    for _ in range(4):
        jl.append(float(jstep((jp.to_tensor(src.astype(np.int32)),
                               jp.to_tensor(tin.astype(np.int32))),
                              (jp.to_tensor(tout.astype(np.int32)),))
                        .numpy()))
        tl.append(tstep((torch.from_numpy(src), torch.from_numpy(tin)),
                        (torch.from_numpy(tout),)).item())
        jsched.step()
        tsched.step()
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    own = dict(tstep.layer.named_parameters())
    for name, arr in jstep.params.items():
        if name.endswith("k_proj.bias"):
            continue
        np.testing.assert_allclose(own[name].detach().numpy(),
                                   np.asarray(arr), atol=1e-3, rtol=0,
                                   err_msg=name)


def test_mt_flops_count(cs):
    """mt_train_flops at Transformer-base's shape, term by term."""
    w = cs.mt_train_flops(32, 128, 96, 37000, **cs.MT_BASE)
    d, ff = 512, 2048
    enc = 6 * 4096 * (4 * d * d + 2 * d * ff + 2 * 128 * d)
    dec = 6 * (3072 * (6 * d * d + 2 * 96 * d + 2 * 128 * d + 2 * d * ff)
               + 4096 * 2 * d * d)
    assert w["macs_encoder"] == enc and w["macs_decoder"] == dec
    assert w["macs_head"] == 3072 * 512 * 37000
    assert w["flops"] == 6 * (enc + dec + 3072 * 512 * 37000)
