"""The port's MoE (paddle_tpu_torch/distributed/moe.py) and ERNIE-MoE
against the JAX package's (paddle_tpu/distributed/moe.py, models/ernie.py).

- moe_dispatch: the port routes in index form (moe_route) and expands
  the indices into the JAX package's dense (combine [N, E, C], dispatch
  [N, E, C], aux); at top_k 1, 2 and 3, at a capacity that drops tokens,
  and in the tests/test_moe.py:74 overflow case, dispatch must equal
  the JAX package's exactly, and combine and aux to one f32 rounding of
  the softmax (rtol 1e-6, atol 0: every zero of combine where the JAX
  package's is zero; torch's exp and XLA's differ in the last bit).
- MoELayer: the same weights (carried from the JAX layer), the same
  input; y, the aux loss and the gradients of x, gate, w1, b1, w2 and b2
  within f32 1e-5, with relu and with gelu (jax.nn's tanh form in both).
- Tiny ERNIE-MoE (4 layers, every 2nd a 4-expert top-2 mixture, dropout
  0): its state_dict carried across by models/convert.py
  (load_jax_params), the pretraining loss plus 0.01 x the aux loss, the
  aux loss and every gradient within 1e-5; shard_for_rank gives each
  rank of an ep x tp plan its block of every full array.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.distributed as jdist
from paddle_tpu.distributed import MoELayer as JMoE
from paddle_tpu.distributed.moe import moe_dispatch as jdispatch
from paddle_tpu.models import ErnieConfig as JConfig
from paddle_tpu.models import ErnieForPretraining as JErnie

import paddle_tpu_torch as pt
from paddle_tpu_torch import distributed as pdist
from paddle_tpu_torch.distributed.moe import MoELayer as TMoE
from paddle_tpu_torch.distributed.moe import moe_dispatch, moe_route
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     load_jax_params, shard_for_rank)

TOL = 1e-5


@pytest.fixture(autouse=True)
def fresh_mesh():
    jdist.set_mesh(None)
    pdist.set_mesh(None)
    yield
    jdist.set_mesh(None)
    pdist.set_mesh(None)


def _dispatch_both(logits, e, k, c):
    jc, jd, ja = jdispatch(jnp.asarray(logits), num_experts=e, top_k=k,
                           capacity=c)
    tc, td, ta = moe_dispatch(torch.from_numpy(logits), e, k, c)
    return (np.asarray(jc), np.asarray(jd), float(ja)), \
        (tc.numpy(), td.numpy(), float(ta))


def test_overflow_case_equals_jax():
    """tests/test_moe.py:74: 5 tokens on one expert, capacity 2."""
    logits = np.tile([5.0, 0.0, 0.0], (5, 1)).astype(np.float32)
    (jc, jd, ja), (tc, td, ta) = _dispatch_both(logits, 3, 1, 2)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    assert int(td.sum()) == 2


@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("cap_factor", [0.5, 1.25, 4.0])
def test_dispatch_equals_jax(top_k, cap_factor):
    rng = np.random.RandomState(top_k)
    n, e = 48, 4
    logits = (rng.randn(n, e) * 2).astype(np.float32)
    c = max(top_k, int(np.ceil(n / e * cap_factor * top_k)))
    (jc, jd, ja), (tc, td, ta) = _dispatch_both(logits, e, top_k, c)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)
    if cap_factor < 1:
        assert td.sum() < n * top_k            # some tokens dropped
    r = moe_route(torch.from_numpy(logits), e, top_k, c)
    assert int(r.keep.sum()) == int(td.sum())


def _np(t):
    return np.asarray(t._data)


def _moe_pair(activation, seed):
    paddle.seed(seed)
    d, h, e = 8, 16, 4
    jm = JMoE(d, h, num_experts=e, top_k=2, capacity_factor=1.0,
              activation=activation)
    tm = TMoE(d, h, num_experts=e, top_k=2, capacity_factor=1.0,
              activation=activation, device="cpu")
    tm.set_state_dict({k: _np(v) for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_moe_layer_forward_and_grads_equal_jax(activation):
    jm, tm = _moe_pair(activation, 3)
    rng = np.random.RandomState(5)
    x = rng.randn(3, 10, 8).astype(np.float32)
    w = rng.randn(3, 10, 8).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = jm(jx)
    jl = (jy * paddle.to_tensor(w)).sum() + 0.5 * jm.aux_loss
    jl.backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tm(tx)
    tl = (ty * torch.from_numpy(w)).sum() + 0.5 * tm.aux_loss
    tl.backward()
    np.testing.assert_allclose(ty.detach().numpy(), _np(jy), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(float(tm.aux_loss), float(_np(jm.aux_loss)),
                               rtol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               atol=TOL, rtol=TOL)
    for name in ("gate", "w1", "b1", "w2", "b2"):
        np.testing.assert_allclose(
            getattr(tm, name).grad.numpy(),
            np.asarray(getattr(jm, name).grad.numpy()), atol=TOL, rtol=TOL,
            err_msg=name)
    # some slots dropped at capacity factor 1, as the JAX layer drops them
    assert int(tm.last_kept) < tm.last_routed


# ErnieConfig.tiny's widths at 4 layers
MOE_CFG = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=4,
               num_attention_heads=4, intermediate_size=128,
               max_position_embeddings=64, moe_num_experts=4, moe_top_k=2,
               hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def ernie_pair():
    paddle.seed(0)
    jm = JErnie(JConfig(**MOE_CFG))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ErnieForPretraining(ErnieConfig(**MOE_CFG), device="cpu")
    load_jax_params(tm, state)
    return jm, tm, state


def test_ernie_moe_loss_aux_and_grads_equal_jax(ernie_pair):
    jm, tm, _ = ernie_pair
    jm.train()
    tm.train()
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 1024, (2, 32)).astype(np.int64)
    lbl = rng.randint(0, 1024, (2, 32)).astype(np.int64)
    jout = jm(paddle.to_tensor(ids.astype(np.int32)))
    jaux = jm.moe_aux_loss()
    jl = JErnie.pretraining_loss(jout, paddle.to_tensor(
        lbl.astype(np.int32))) + 0.01 * jaux
    jl.backward()
    tout = tm(torch.from_numpy(ids))
    taux = tm.moe_aux_loss()
    tl = ErnieForPretraining.pretraining_loss(
        tout, torch.from_numpy(lbl)) + 0.01 * taux
    tl.backward()
    np.testing.assert_allclose(float(tl), float(jl.numpy()), rtol=TOL)
    np.testing.assert_allclose(float(taux), float(jaux.numpy()), rtol=TOL)
    # the pooler and the NSP head are off the loss: no grad in either
    jgrads = {k: None if v.grad is None else np.asarray(v.grad.numpy())
              for k, v in jm.named_parameters()}
    n_moe = 0
    for k, p in tm.named_parameters():
        if jgrads[k] is None:
            assert p.grad is None or not p.grad.any(), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), jgrads[k], atol=TOL,
                                   rtol=TOL, err_msg=k)
        n_moe += ".moe." in k
    assert n_moe == 2 * 5      # layers 1 and 3: gate, w1, b1, w2, b2


def test_shard_for_rank_cuts_every_array_by_the_plan(ernie_pair):
    """Each rank of an ep 2 x tp 2 mesh (a ShardingPlan over it) gets
    the block of every full array its spec names, the model axes'
    contiguous blocks; replicated arrays whole. The blocks of the 4 ranks
    reassemble each array."""
    _, tm, state = ernie_pair
    mesh = pdist.build_mesh({"ep": 2, "tp": 2}, devices=range(4))
    plan = pdist.ShardingPlan(mesh)
    named = tm.state_dict(keep_vars=True)
    shards = [shard_for_rank(state, plan, r, named) for r in range(4)]
    w1 = "ernie.encoder.1.moe.w1"
    assert shards[0][w1].shape == (2, 64, 128)
    np.testing.assert_array_equal(
        np.concatenate([shards[0][w1], shards[2][w1]]), state[w1])
    np.testing.assert_array_equal(shards[1][w1], shards[0][w1])  # tp copy
    qkv = "ernie.encoder.0.attention.qkv.weight"
    np.testing.assert_array_equal(
        np.concatenate([shards[0][qkv], shards[1][qkv]], axis=1),
        state[qkv])
    emb = "ernie.embeddings.word_embeddings.weight"
    assert shards[3][emb].shape == (512, 64)
    gate = "ernie.encoder.1.moe.gate"
    np.testing.assert_array_equal(shards[3][gate], state[gate])


def test_moe_trainstep_trajectory_is_deterministic_and_falls():
    """A 3-step TrainStep of tiny ERNIE-MoE (2 layers) on the CPU: two
    runs from one seed give the same losses bit for bit, and the loss
    falls."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, 1024, (2, 16)).astype(np.int64))
    cfg = dict(MOE_CFG, num_hidden_layers=2)
    runs = []
    for _ in range(2):
        pt.seed(0)
        m = ErnieForPretraining(ErnieConfig(**cfg), device="cpu")

        def loss(out, y, m=m):
            return (ErnieForPretraining.pretraining_loss(out, y)
                    + 0.01 * m.moe_aux_loss())
        st = TrainStep(m, loss, AdamW(learning_rate=3e-3))
        runs.append([float(st(ids, ids, seed=s)) for s in range(3)])
    assert runs[0] == runs[1]
    assert runs[0][-1] < runs[0][0]
