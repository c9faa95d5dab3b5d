"""The capture-ready TrainStep body on the CPU.

On the card TrainStep captures its step as one CUDA graph per input
signature; the CPU runs the same body eagerly, so these tests hold what
the capture relies on:
- the seed slots (core/generator.py SeedSlots): the body run with every
  draw taken from a slot (a view of one int64 buffer, or a generator of
  its own, written by fill()) equals the host-int body of the same step
  seed bit for bit, with grad accumulation too; the plain attention
  reading a seed tensor draws the masks of the int seed; the step seed
  decides the loss (same seed, same loss; another seed, another loss);
- the learning rate as data: under LinearWarmup the 4-step trajectory
  equals the JAX TrainStep's with the same scheduler within 1e-4 (the
  plain trajectories' tolerance, tests/test_torch_training.py);
- the sentinel: a second input signature records one event, a repeated
  one none;
- in-place state: set_state_dict keeps every tensor's identity (the
  model's, the optimizer's, the loss scale's) and reproduces the loss;
- build_eval_fn equals the JAX package's eval function at f32 (1e-5:
  other summation order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import ErnieConfig as JaxConfig
from paddle_tpu.models import ErnieForPretraining as JaxErnie
from paddle_tpu.static import TrainStep as JaxTrainStep
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp, optimizer as topt
from paddle_tpu_torch.core.generator import SeedSlots, seed_tensor
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     load_jax_params)
from paddle_tpu_torch.observability import signature_of
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import philox
from paddle_tpu_torch.static import TrainStep

NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss(out, labels):
    return ErnieForPretraining.pretraining_loss(out, labels)


def _step(seed=1, **kw):
    pt.seed(seed)
    m = ErnieForPretraining(ErnieConfig.tiny(), device="cpu").train()
    return TrainStep(m, _loss, topt.AdamW(learning_rate=1e-3), **kw)


def _batch(b=2, s=32, seed=0):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randint(0, 1024, (b, s))),
            torch.from_numpy(rng.randint(0, 1024, (b, s))))


def _slot_run(st, x, y, seeds, lr=1e-3):
    """The body as a replay runs it: the first seed records the slots,
    each later one fills them and runs the body on them. Returns the
    losses."""
    slots = SeedSlots("cpu").record(seeds[0])
    lr_t = torch.tensor(lr, dtype=torch.float32)
    losses = [st._body((x,), (y,), lr_t, slots).item()]
    slots.freeze()
    for s in seeds[1:]:
        slots.fill(s)
        lr_t.fill_(lr)
        losses.append(st._body((x,), (y,), lr_t, slots).item())
    return losses, slots


@pytest.mark.parametrize("accum", [1, 2])
def test_slot_body_equals_host_int_body(accum):
    x, y = _batch(b=4)
    seeds = [11, 12, 13]
    a = _step(grad_accum_steps=accum)
    slot_losses, slots = _slot_run(a, x, y, seeds)
    b = _step(grad_accum_steps=accum)
    host_losses = [b.eager_step(x, y, seed=s).item() for s in seeds]
    assert slot_losses == host_losses
    for p, q in zip(a.params, b.params):
        assert torch.equal(p, q)
    # attention (tensor) and hidden dropout (generator) slots, one per
    # draw of each microbatch, laid down in draw order
    kinds = {k for _, k in slots.recipes}
    assert kinds == {"tensor", "generator"}
    assert len(slots.generators) == sum(k == "generator"
                                        for _, k in slots.recipes)
    assert {p[0] for p, _ in slots.recipes} == (
        set(range(accum)) if accum > 1 else set(range(len(slots))))


def test_seed_tensor_draws_the_int_seeds_masks():
    seed = (0xDEADBEEF << 32) | 0x12345678
    t = seed_tensor(seed, "cpu")
    assert t.dtype == torch.int64 and t.dim() == 0
    assert [int(w) for w in philox.split_seed(t)] == \
        list(philox.split_seed(seed))
    rows, cols = torch.arange(8)[:, None], torch.arange(12)[None, :]
    bh = torch.arange(3)[:, None, None]
    assert torch.equal(philox.keep_mask(seed, 0.3, bh, rows, cols),
                       philox.keep_mask(t, 0.3, bh, rows, cols))
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rng.randn(2, 16, 2, 8).astype(np.float32))
               for _ in range(3))
    o_int, lse_int = fa.flash_attention_fwd_plain(q, k, v, dropout_p=0.3,
                                                  seed=seed)
    o_t, lse_t = fa.flash_attention_fwd_plain(q, k, v, dropout_p=0.3,
                                              seed=t)
    assert torch.equal(o_int, o_t) and torch.equal(lse_int, lse_t)
    do = torch.from_numpy(rng.randn(2, 16, 2, 8).astype(np.float32))
    for a, b in zip(fa.flash_attention_bwd_plain(q, k, v, o_t, lse_t, do,
                                                 dropout_p=0.3, seed=seed),
                    fa.flash_attention_bwd_plain(q, k, v, o_t, lse_t, do,
                                                 dropout_p=0.3, seed=t)):
        assert torch.equal(a, b)


def test_step_seed_decides_the_loss():
    x, y = _batch()
    st = _step()
    snap = st.state_dict()
    a = st(x, y, seed=5).item()
    st.set_state_dict(snap)
    b = st(x, y, seed=5).item()
    st.set_state_dict(snap)
    c = st(x, y, seed=6).item()
    assert a == b and a != c


def test_linear_warmup_trajectory_matches_jax():
    from paddle_tpu.optimizer.lr import LinearWarmup as JWarmup
    from paddle_tpu_torch.optimizer.lr import LinearWarmup
    paddle.seed(0)
    jm = JaxErnie(JaxConfig.tiny(**NO_DROP))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ErnieForPretraining(ErnieConfig.tiny(**NO_DROP), device="cpu")
    load_jax_params(tm, state)
    kw = dict(learning_rate=2e-3, warmup_steps=3, start_lr=0.0, end_lr=2e-3)
    jsched, tsched = JWarmup(**kw), LinearWarmup(**kw)

    def jloss(out, labels):
        return JaxErnie.pretraining_loss(out, labels)
    jstep = JaxTrainStep(jm, jloss, paddle.optimizer.AdamW(
        learning_rate=jsched, weight_decay=0.01))
    tstep = TrainStep(tm, _loss, topt.AdamW(learning_rate=tsched,
                                            weight_decay=0.01))
    rng = np.random.RandomState(7)
    jl, tl, lrs = [], [], []
    for _ in range(4):
        ids = rng.randint(0, 1024, (2, 32)).astype(np.int64)
        lbl = rng.randint(0, 1024, (2, 32)).astype(np.int64)
        lrs.append(tsched.get_lr())
        jl.append(float(jstep(paddle.to_tensor(ids.astype(np.int32)),
                              paddle.to_tensor(lbl.astype(np.int32)))
                        .numpy()))
        tl.append(tstep(torch.from_numpy(ids), torch.from_numpy(lbl))
                  .item())
        jsched.step()
        tsched.step()
    assert lrs[0] == 0.0 and lrs[-1] == 2e-3
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    own = dict(tm.named_parameters())
    for name, arr in jstep.params.items():
        np.testing.assert_allclose(own[name].detach().numpy(),
                                   np.asarray(arr), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_sentinel_counts_signatures():
    st = _step()
    x, y = _batch()
    st(x, y)
    st(x, y)
    assert st.programs == 1 and st.recompile_sentinel.fired == 0
    x2, y2 = _batch(b=3)
    st(x2, y2)
    assert st.programs == 2 and st.recompile_sentinel.fired == 1
    ev = st.recompile_sentinel.events[0]
    assert ev["executables"] == 2
    assert "[0][0]: (2, 32)/torch.int64 -> (3, 32)/torch.int64" in ev["diff"]
    st(x2, y2)
    st(x, y)
    assert st.recompile_sentinel.fired == 1
    assert signature_of((x,), (y,)) == (("[0][0]", (2, 32), "torch.int64"),
                                        ("[1][0]", (2, 32), "torch.int64"))


def test_set_state_dict_is_in_place_and_reproduces_the_loss():
    x, y = _batch()
    st = _step(scaler=amp.GradScaler(init_loss_scaling=8.0))
    st(x, y, seed=1)
    ck = st.state_dict()
    tensors = ([t for t in st.layer.state_dict().values()]
               + [t for p in st.params
                  for t in st.optimizer._accumulators[id(p)].values()]
               + list(st.strategy_state.values()))
    ptrs = [t.data_ptr() for t in tensors]
    a = st(x, y, seed=2).item()
    st(x, y, seed=3)
    st.set_state_dict(ck)
    assert [t.data_ptr() for t in tensors] == ptrs
    assert st(x, y, seed=2).item() == a


def test_build_eval_fn_matches_jax():
    paddle.seed(0)
    jm = JaxErnie(JaxConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ErnieForPretraining(ErnieConfig.tiny(), device="cpu").train()
    load_jax_params(tm, state)

    def jloss(out, labels):
        return JaxErnie.pretraining_loss(out, labels)
    jstep = JaxTrainStep(jm, jloss, paddle.optimizer.AdamW())
    tstep = TrainStep(tm, _loss, topt.AdamW())
    ids = np.random.RandomState(3).randint(0, 1024, (2, 24))
    import jax
    jout = jstep.build_eval_fn()(jstep.params, jstep.buffers,
                                 jax.random.key(0),
                                 (np.asarray(ids, np.int32),))
    ev = tstep.build_eval_fn()
    tout = ev(torch.from_numpy(ids))
    assert tm.training            # the training flag is restored
    assert ev.programs == 1
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)
