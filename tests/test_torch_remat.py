"""Rematerialisation: TrainStep(remat=True) and distributed.recompute.

- Tiny ERNIE and tiny GPT with dropout 0.1: a remat step (policy None,
  "nothing_saveable", "checkpoint_dots") gives losses and every gradient
  bit-equal to the plain step from the same weights and step seeds, over
  two steps: the recompute draws the same masks as the forward (the seed
  scope is rewound at the region's entry), and runs the same ops on the
  same inputs. The recompute really runs: the attention forward runs
  twice per layer and step.
- At dropout 0, the port's remat TrainStep against the JAX package's
  (jax.checkpoint with the same policy, the way RecomputeOptimizer sets
  it): the step-1 loss within 1e-5 relative, as
  tests/test_fleet_meta.py holds the JAX remat step against its plain
  one, and the 3-step trajectory within 1e-4 (the plain trajectories'
  tolerance, tests/test_torch_training.py).
- recompute and recompute_sequential against the JAX package's on the
  same numpy weights: outputs and the input's gradient within 1e-5 (f32,
  other summation order). The JAX recompute differentiates its
  arguments only (weights closed over are constants there), so the
  weights' gradients are held against the port's plain run instead,
  bit for bit; with dropout, recompute's gradient is bit-equal to the
  plain function's under the seed recompute draws.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed.recompute import \
    recompute_sequential as jrecompute_sequential
from paddle_tpu.models import ErnieConfig as JErnieConfig
from paddle_tpu.models import ErnieForPretraining as JErnie
from paddle_tpu.static import TrainStep as JTrainStep
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import distributed as tdist
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.core.generator import next_seed, seed_scope
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     GPTConfig, GPTForCausalLM,
                                     load_jax_params)
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.static import TrainStep

POLICIES = [None, "nothing_saveable", "checkpoint_dots"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ernie_loss(out, labels):
    return ErnieForPretraining.pretraining_loss(out, labels)


def _model(kind, seed=1, dropout=0.1):
    pt.seed(seed)
    if kind == "ernie":
        cfg = ErnieConfig.tiny(hidden_dropout_prob=dropout,
                               attention_probs_dropout_prob=dropout)
        return ErnieForPretraining(cfg, device="cpu").train(), _ernie_loss
    return (GPTForCausalLM(GPTConfig.tiny(dropout=dropout),
                           device="cpu").train(), GPTForCausalLM.lm_loss)


def _batch(vocab, b=2, s=32, seed=0):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randint(0, vocab, (b, s))),
            torch.from_numpy(rng.randint(0, vocab, (b, s))))


def _steps(kind, n=2, **kw):
    """n steps (step seeds 100, 101, ...); per step the loss and the
    gradient of every parameter (None where a parameter takes none)."""
    model, loss_fn = _model(kind)
    st = TrainStep(model, loss_fn, topt.AdamW(learning_rate=1e-3), **kw)
    x, y = _batch(model.config.vocab_size)
    out = []
    for i in range(n):
        loss = st(x, y, seed=100 + i)
        out.append((loss.item(), [None if p.grad is None else p.grad.clone()
                                  for p in st.params]))
    return out


@pytest.mark.parametrize("kind", ["ernie", "gpt"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_step_is_bit_equal_to_plain_with_dropout(kind, policy):
    plain = _steps(kind)
    remat = _steps(kind, remat=True, remat_policy=policy)
    for (la, ga), (lb, gb) in zip(plain, remat):
        assert la == lb
        for a, b in zip(ga, gb):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("remat", [False, True])
def test_remat_runs_the_attention_forward_again(monkeypatch, remat):
    """Through the autograd Function (the kernels' route), the remat
    step runs each layer's attention forward twice: the forward and its
    recompute."""
    monkeypatch.setenv("PD_ATTN_DROPOUT_IMPL", "kernel")
    calls = []
    real = fa.flash_attention_fwd_plain
    monkeypatch.setattr(fa, "flash_attention_fwd_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model, loss_fn = _model("gpt")
    st = TrainStep(model, loss_fn, topt.AdamW(learning_rate=1e-3),
                   remat=remat)
    x, y = _batch(model.config.vocab_size)
    st(x, y, seed=3)
    assert len(calls) == model.config.num_layers * (2 if remat else 1)


def test_remat_policy_is_checked():
    model, loss_fn = _model("gpt")
    with pytest.raises(ValueError, match="remat_policy"):
        TrainStep(model, loss_fn, topt.AdamW(), remat=True,
                  remat_policy="everything_saveable")


@pytest.mark.parametrize("policy", ["nothing_saveable", "checkpoint_dots"])
def test_remat_trainstep_matches_jax(policy):
    kw = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    paddle.seed(0)
    jm = JErnie(JErnieConfig.tiny(**kw))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ErnieForPretraining(ErnieConfig.tiny(**kw), device="cpu")
    load_jax_params(tm, state)

    def jloss(out, labels):
        return JErnie.pretraining_loss(out, labels)
    jstep = JTrainStep(jm, jloss, paddle.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01), remat=True,
        remat_policy=getattr(jax.checkpoint_policies, policy))
    tstep = TrainStep(tm, _ernie_loss, topt.AdamW(learning_rate=1e-3,
                                                  weight_decay=0.01),
                      remat=True, remat_policy=policy)
    rng = np.random.RandomState(7)
    jl, tl = [], []
    for _ in range(3):
        ids = rng.randint(0, 1024, (2, 32)).astype(np.int64)
        lbl = rng.randint(0, 1024, (2, 32)).astype(np.int64)
        jl.append(float(jstep(paddle.to_tensor(ids.astype(np.int32)),
                              paddle.to_tensor(lbl.astype(np.int32)))
                        .numpy()))
        tl.append(tstep(torch.from_numpy(ids), torch.from_numpy(lbl))
                  .item())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


# ------------------------------------------------------------ recompute

def _weights(seed=29):
    rng = np.random.RandomState(seed)
    return [rng.randn(4, 8).astype(np.float32) * 0.5,
            rng.randn(8).astype(np.float32) * 0.1,
            rng.randn(8, 4).astype(np.float32) * 0.5,
            rng.randn(4).astype(np.float32) * 0.1]


def _jax_layers(ws):
    jw = [paddle.to_tensor(w) for w in ws]
    for t in jw:
        t.stop_gradient = False
    JF = paddle.nn.functional
    return jw, [lambda t: JF.linear(t, jw[0], jw[1]), paddle.tanh,
                lambda t: JF.linear(t, jw[2], jw[3])]


def _torch_layers(ws):
    tw = [torch.from_numpy(w.copy()).requires_grad_(True) for w in ws]
    return tw, [lambda t: F.linear(t, tw[0], tw[1]), torch.tanh,
                lambda t: F.linear(t, tw[2], tw[3])]


def _chain(layers):
    def f(x):
        for layer in layers:
            x = layer(x)
        return x
    return f


@pytest.mark.parametrize("form", ["recompute", "sequential"])
def test_recompute_matches_jax(form):
    ws = _weights()
    x = np.random.RandomState(30).randn(3, 4).astype(np.float32)
    jw, jl = _jax_layers(ws)
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    tw, tl = _torch_layers(ws)
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    if form == "recompute":
        jy = jdist.recompute(_chain(jl), jx)
        ty = tdist.recompute(_chain(tl), tx)
    else:
        jy = jrecompute_sequential({"segments": 2}, jl, jx)
        ty = tdist.recompute_sequential({"segments": 2}, tl, tx)
    (jy * jy).sum().backward()
    (ty * ty).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), atol=1e-5,
                               rtol=1e-5)
    pw, pl = _torch_layers(ws)
    px = torch.from_numpy(x.copy()).requires_grad_(True)
    py = _chain(pl)(px)
    (py * py).sum().backward()
    for a, b in zip([tx] + tw, [px] + pw):
        assert torch.equal(a.grad, b.grad)


def test_recompute_repeats_the_forward_masks():
    """A segment with dropout: recompute's gradient equals the plain
    function's run under the seed recompute draws (the next of the
    stream), bit for bit."""
    ws = _weights()
    x = np.random.RandomState(31).randn(16, 4).astype(np.float32)

    def seg(layers):
        def f(t):
            for layer in layers:
                t = F.dropout(layer(t), p=0.3)
            return t
        return f
    grads = []
    for use_recompute in (True, False):
        tw, tl = _torch_layers(ws)
        tx = torch.from_numpy(x.copy()).requires_grad_(True)
        pt.seed(5)
        if use_recompute:
            y = tdist.recompute(seg(tl), tx)
        else:
            with seed_scope(next_seed("cpu")):
                y = seg(tl)(tx)
        (y * y).sum().backward()
        grads.append([tx.grad] + [w.grad for w in tw])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
