"""The port's training slice against the JAX package's: the CE head,
AMP, AdamW, LR schedulers, loss scaling and TrainStep.

Same numpy inputs on both sides; weights cross by name
(load_jax_params). Tolerances, each for its reason:
- cross_entropy value and gradient 1e-5 (f32 on both sides, reductions
  in another order);
- AdamW 1e-6 over 5 steps (the same f32 rule; foreach ops round the
  products in another order);
- the tiny-ERNIE TrainStep: f32 losses per step at 1e-4 relative and
  final params at 1e-4 (tests/conftest.py sets JAX matmuls to
  "highest"; the two frameworks sum in another order, and 4 AdamW steps
  amplify the difference where sqrt(v) ~ eps); O1 bf16 losses within
  2e-2 relative (bf16 rounds at other places in the two frameworks);
- grad_accum_steps=2 against 1 on the same batch at 1e-5.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu.models import ErnieConfig as JaxConfig
from paddle_tpu.models import ErnieForPretraining as JaxErnie
from paddle_tpu.static import TrainStep as JaxTrainStep
from paddle_tpu_torch import amp, optimizer as topt
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,
                                     load_jax_params)
from paddle_tpu_torch.static import TrainStep

NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """tier-1 runs several pytest workers on one CPU: torch's default
    thread pool then oversubscribes it and its small ops slow down 20x
    or more, so these tests run torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_fn(out, labels):
    return ErnieForPretraining.pretraining_loss(out, labels)


def _jax_loss_fn(out, labels):
    return JaxErnie.pretraining_loss(out, labels)


# ------------------------------------------------------------------ loss

@pytest.mark.parametrize("shape", [(12, 50), (2, 6, 37)])
def test_cross_entropy_matches_jax(shape):
    rng = np.random.RandomState(0)
    logits = rng.randn(*shape).astype(np.float32) * 3
    labels = rng.randint(0, shape[-1], shape[:-1]).astype(np.int64)
    labels.reshape(-1)[::4] = -100
    jx = paddle.to_tensor(logits, stop_gradient=False)
    jl = JF.cross_entropy(jx, paddle.to_tensor(labels))
    jl.backward()
    tx = torch.from_numpy(logits).requires_grad_(True)
    tl = F.cross_entropy(tx, torch.from_numpy(labels))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(),
                               atol=1e-5, rtol=1e-5)
    none = F.cross_entropy(torch.from_numpy(logits),
                           torch.from_numpy(labels), reduction="none")
    assert none.shape == shape[:-1] and (none.reshape(-1)[::4] == 0).all()
    swce = F.softmax_with_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(labels))
    assert swce.shape == shape[:-1] + (1,)
    torch.testing.assert_close(swce[..., 0], none)


def test_cross_entropy_keeps_bf16_logits_low(monkeypatch):
    """bf16 logits stay bf16 (dlogits too); the f32 work runs chunk by
    chunk (forced to 3-row chunks here) and matches one f32 pass."""
    from paddle_tpu_torch.nn.functional import loss as L
    rng = np.random.RandomState(1)
    logits = torch.from_numpy(rng.randn(10, 40).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 40, 10))
    ref = F.cross_entropy(logits.to(torch.bfloat16).float(), labels)
    monkeypatch.setattr(L, "_CHUNK_ELEMS", 120)
    x = logits.to(torch.bfloat16).requires_grad_(True)
    out = F.cross_entropy(x, labels)
    out.backward()
    assert out.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ AMP

def test_o1_dtypes_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 8).astype(np.float32)
    w = rng.randn(8, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    lbl = rng.randint(0, 6, 4)
    jt = {k: paddle.to_tensor(v) for k, v in
          dict(x=x, w=w, b=b).items()}
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jy = JF.linear(jt["x"], jt["w"], jt["b"])
        jn = JF.layer_norm(jy, 6)
    tt = {k: torch.from_numpy(v) for k, v in dict(x=x, w=w, b=b).items()}
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        ty = F.linear(tt["x"], tt["w"], tt["b"])
        tn = F.layer_norm(ty, 6)
        ts = F.softmax(ty)
        tce = F.cross_entropy(ty, torch.from_numpy(lbl), reduction="none")
        q = torch.from_numpy(rng.randn(1, 8, 2, 16).astype(np.float32))
        tf = F.flash_attention(q, q, q, training=False)
    assert str(jy.dtype).endswith("bfloat16") and ty.dtype == torch.bfloat16
    assert str(jn.dtype).endswith("float32") and tn.dtype == torch.float32
    assert ts.dtype == torch.float32
    assert tf.dtype == torch.bfloat16
    # CE keeps the bf16 logits and returns an f32 loss
    assert tce.dtype == torch.float32
    np.testing.assert_allclose(ty.float().numpy(),
                               np.asarray(jy.numpy(), np.float32),
                               atol=1e-2, rtol=1e-2)
    with amp.auto_cast(level="O2"):
        assert F.linear(tt["x"], tt["w"]).dtype == torch.bfloat16
        assert F.layer_norm(tt["x"], 8).dtype == torch.float32
    assert F.linear(tt["x"], tt["w"]).dtype == torch.float32


# ------------------------------------------------------------------ AdamW

def _adamw_pair(multi_precision, jdtype, tdtype):
    import jax.numpy as jnp
    from paddle_tpu.optimizer import AdamW as JAdamW
    rng = np.random.RandomState(3)
    shapes = [(7, 5), (5,)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    jo = JAdamW(learning_rate=1e-2, weight_decay=0.01,
                multi_precision=multi_precision)
    jp = {str(i): jnp.asarray(a).astype(jdtype) for i, a in enumerate(init)}
    js = jo.init_state_tree(jp)
    tp = [torch.from_numpy(a).to(tdtype) for a in init]
    to = topt.AdamW(learning_rate=1e-2, weight_decay=0.01,
                    multi_precision=multi_precision, parameters=tp)
    for gs in grads:
        jp, js = jo.apply_gradients_tree(
            jp, {str(i): jnp.asarray(g).astype(jdtype)
                 for i, g in enumerate(gs)}, js)
        to.apply_gradients(tp, [torch.from_numpy(g).to(tdtype) for g in gs])
    return jp, js, tp, to


def test_adamw_matches_jax_f32():
    import jax.numpy as jnp
    jp, js, tp, to = _adamw_pair(False, jnp.float32, torch.float32)
    for i, p in enumerate(tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[str(i)]),
                                   atol=1e-6, rtol=1e-6)
        st = to._accumulators[id(p)]
        for name in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
            np.testing.assert_allclose(st[name].numpy(),
                                       np.asarray(js[str(i)][name]),
                                       atol=1e-6, rtol=1e-6, err_msg=name)


def test_adamw_multi_precision_bf16_matches_jax():
    import jax.numpy as jnp
    jp, js, tp, to = _adamw_pair(True, jnp.bfloat16, torch.bfloat16)
    for i, p in enumerate(tp):
        assert p.dtype == torch.bfloat16
        master = to._accumulators[id(p)]["master_weight"]
        assert master.dtype == torch.float32
        np.testing.assert_allclose(
            master.numpy(), np.asarray(js[str(i)]["master_weight"]),
            atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(
            p.float().numpy(), np.asarray(jp[str(i)], np.float32),
            atol=1e-6, rtol=1e-6)


def test_adam_coupled_decay_and_state_dict_roundtrip():
    rng = np.random.RandomState(4)
    p = torch.from_numpy(rng.randn(6).astype(np.float32))
    o = topt.Adam(learning_rate=0.1, weight_decay=0.5, parameters=[p])
    o.apply_gradients([p], [torch.ones(6)])
    sd = o.state_dict()
    assert set(sd["param_0"]) == {"moment1", "moment2", "beta1_pow",
                                  "beta2_pow"}
    q = p.clone()
    o2 = topt.Adam(learning_rate=0.1, weight_decay=0.5, parameters=[q])
    o2.set_state_dict(sd)
    o.apply_gradients([p], [torch.ones(6)])
    o2.apply_gradients([q], [torch.ones(6)])
    torch.testing.assert_close(p, q, atol=0, rtol=0)


@pytest.mark.parametrize("name,args", [
    ("NoamDecay", dict(d_model=64, warmup_steps=3)),
    ("PiecewiseDecay", dict(boundaries=[2, 5], values=[1.0, 0.5, 0.1])),
    ("PolynomialDecay", dict(learning_rate=0.5, decay_steps=6)),
    ("LinearWarmup", dict(learning_rate=0.5, warmup_steps=4,
                          start_lr=0.0, end_lr=0.5)),
    ("CosineAnnealingDecay", dict(learning_rate=0.3, T_max=7)),
    ("OneCycleLR", dict(max_learning_rate=0.2, total_steps=10)),
    ("StepDecay", dict(learning_rate=0.4, step_size=3)),
])
def test_lr_scheduler_table_matches_jax(name, args):
    import paddle_tpu.optimizer.lr as jlr
    from paddle_tpu_torch.optimizer import lr as tlr
    js, ts = getattr(jlr, name)(**args), getattr(tlr, name)(**args)
    table = []
    for _ in range(10):
        table.append((js(), ts()))
        js.step()
        ts.step()
    assert all(math.isclose(a, b, rel_tol=1e-12) for a, b in table), table
    o = topt.AdamW(learning_rate=ts, parameters=[torch.zeros(1)])
    assert o.get_lr() == ts()


# ------------------------------------------------------------------ scaler

class _Lin(pt.nn.Layer):
    def __init__(self):
        super().__init__(device="cpu")
        self.fc = pt.nn.Linear(4, 3, device="cpu")

    def forward(self, x):
        return self.fc(x)


def test_scaler_skip_keeps_params_and_moments():
    pt.seed(0)
    layer = _Lin()
    opt = topt.AdamW(learning_rate=0.1)
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    step = TrainStep(layer, lambda o, y: ((o - y) ** 2).mean(), opt,
                     scaler=scaler)
    x = torch.ones(2, 4)
    y = torch.zeros(2, 3)
    step(x, y)  # a clean step creates the optimizer state
    before = {k: v.clone() for k, v in layer.state_dict().items()}
    moments = {id(p): {k: v.clone() for k, v in opt._accumulators[id(p)]
                       .items()} for p in layer.parameters()}
    loss = step(torch.full((2, 4), float("inf")), y)
    assert isinstance(loss, torch.Tensor) and not loss.requires_grad
    for k, v in layer.state_dict().items():
        assert torch.equal(v, before[k]), k
    for p in layer.parameters():
        for k, v in opt._accumulators[id(p)].items():
            assert torch.equal(v, moments[id(p)][k]), k
    st = step.strategy_state
    assert st["amp_scale"].item() == 512.0
    assert st["amp_skipped"].item() == 1
    step(x, y)
    assert not torch.equal(layer.fc.weight, before["fc.weight"])
    assert st["amp_skipped"].item() == 1


def test_eager_scaler_step_skips_on_overflow():
    pt.seed(0)
    layer = _Lin()
    opt = topt.AdamW(learning_rate=0.1, parameters=layer.parameters())
    scaler = amp.GradScaler(init_loss_scaling=8.0)
    w0 = layer.fc.weight.detach().clone()
    scaler.scale(layer(torch.full((1, 4), float("inf"))).sum()).backward()
    scaler.step(opt)
    assert torch.equal(layer.fc.weight, w0)
    assert scaler.get_loss_scaling() == 4.0
    opt.clear_grad()
    scaler.scale(layer(torch.ones(1, 4)).sum()).backward()
    scaler.step(opt)
    assert not torch.equal(layer.fc.weight, w0)


# ------------------------------------------------------------------ TrainStep

def _batches(n, b=2, s=32, vocab=1024):
    rng = np.random.RandomState(7)
    return [(rng.randint(0, vocab, (b, s)).astype(np.int64),
             rng.randint(0, vocab, (b, s)).astype(np.int64))
            for _ in range(n)]


def _pair(amp_level=None):
    paddle.seed(0)
    jm = JaxErnie(JaxConfig.tiny(**NO_DROP))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ErnieForPretraining(ErnieConfig.tiny(**NO_DROP), device="cpu")
    load_jax_params(tm, state)
    jstep = JaxTrainStep(jm, _jax_loss_fn, paddle.optimizer.AdamW(
        learning_rate=1e-3, weight_decay=0.01), amp_level=amp_level)
    tstep = TrainStep(tm, _loss_fn, topt.AdamW(learning_rate=1e-3,
                                               weight_decay=0.01),
                      amp_level=amp_level)
    return jstep, tstep


def _run(jstep, tstep, batches):
    jl, tl = [], []
    for ids, lbl in batches:
        jl.append(float(jstep(paddle.to_tensor(ids.astype(np.int32)),
                              paddle.to_tensor(lbl.astype(np.int32)))
                        .numpy()))
        tl.append(tstep(torch.from_numpy(ids), torch.from_numpy(lbl))
                  .item())
    return np.array(jl), np.array(tl)


def test_trainstep_f32_trajectory_matches_jax():
    jstep, tstep = _pair()
    jl, tl = _run(jstep, tstep, _batches(4))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    own = dict(tstep.layer.named_parameters())
    for name, arr in jstep.params.items():
        np.testing.assert_allclose(own[name].detach().numpy(),
                                   np.asarray(arr), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


def test_trainstep_o1_bf16_losses_close_to_jax():
    jstep, tstep = _pair("O1")
    jl, tl = _run(jstep, tstep, _batches(3))
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=2e-2)
    # O1 keeps f32 params
    assert all(p.dtype == torch.float32 for p in tstep.params)


def test_grad_accum_equals_single_step():
    (ids, lbl), = _batches(1, b=4)
    steps = []
    for accum in (1, 2):
        pt.seed(0)
        m = ErnieForPretraining(ErnieConfig.tiny(**NO_DROP), device="cpu")
        st = TrainStep(m, _loss_fn, topt.AdamW(learning_rate=1e-3),
                       grad_accum_steps=accum)
        losses = [st(torch.from_numpy(ids), torch.from_numpy(lbl)).item()
                  for _ in range(2)]
        steps.append((losses, m.state_dict()))
    np.testing.assert_allclose(steps[1][0], steps[0][0], rtol=1e-5)
    for k, v in steps[0][1].items():
        torch.testing.assert_close(steps[1][1][k], v, atol=1e-5, rtol=1e-5)


def test_trainstep_with_dropout_is_seeded_and_learns():
    (ids, lbl), = _batches(1)
    runs = []
    for _ in range(2):
        pt.seed(1)
        m = ErnieForPretraining(ErnieConfig.tiny(), device="cpu").train()
        st = TrainStep(m, _loss_fn, topt.AdamW(learning_rate=3e-3))
        runs.append([st(torch.from_numpy(ids), torch.from_numpy(lbl)).item()
                     for _ in range(5)])
    assert runs[0] == runs[1]
    assert np.isfinite(runs[0]).all() and runs[0][-1] < runs[0][0]


def test_o2_masters_come_from_original_weights():
    pt.seed(0)
    m = ErnieForPretraining(ErnieConfig.tiny(**NO_DROP), device="cpu")
    orig = {k: v.clone() for k, v in m.named_parameters()}
    opt = topt.AdamW(learning_rate=1e-3)
    st = TrainStep(m, _loss_fn, opt, amp_level="O2")
    for name, p in m.named_parameters():
        assert p.dtype == torch.bfloat16
        master = opt._accumulators[id(p)]["master_weight"]
        assert torch.equal(master, orig[name]), name
    (ids, lbl), = _batches(1)
    loss = st(torch.from_numpy(ids), torch.from_numpy(lbl))
    assert torch.isfinite(loss)


def test_trainstep_state_dict_roundtrip_and_later_flags():
    (ids, lbl), = _batches(1)
    pt.seed(0)
    m = ErnieForPretraining(ErnieConfig.tiny(**NO_DROP), device="cpu")
    st = TrainStep(m, _loss_fn, topt.AdamW(learning_rate=1e-3))
    st(torch.from_numpy(ids), torch.from_numpy(lbl))
    ck = {"model": {k: v.clone() for k, v in m.state_dict().items()},
          "opt": st.optimizer.state_dict(),
          "strategy_state": {}}
    a = st(torch.from_numpy(ids), torch.from_numpy(lbl)).item()
    st.set_state_dict(ck)
    b = st(torch.from_numpy(ids), torch.from_numpy(lbl)).item()
    assert a == b
    # sentry= is taken since item 17 (tests/test_torch_sentry.py holds it)
    from paddle_tpu_torch.observability.sentry import NumericSentry
    armed = TrainStep(m, _loss_fn, topt.AdamW(), sentry=NumericSentry())
    assert "sentry_step" in armed.strategy_state
    # mesh= and grad_transform= are taken since the distributed slice,
    # sharding_plan= and the tp, ep, sp and fsdp axes since the planner
    # (item 14a); a pp axis above size 1 waits for the SPMD pipeline (14d)
    from paddle_tpu_torch.distributed import (MeshPlan, ShardingPlan,
                                              build_mesh, set_mesh)
    TrainStep(m, _loss_fn, topt.AdamW(), mesh=build_mesh({"dp": 1}),
              grad_transform=lambda g, s, p: (g, s))
    try:
        TrainStep(m, _loss_fn, topt.AdamW(),
                  mesh=build_mesh({"dp": 1, "tp": 2}, devices=[0, 1]))
        TrainStep(m, _loss_fn, topt.AdamW(),
                  sharding_plan=ShardingPlan(build_mesh({"dp": 1}),
                                             zero_stage=3))
        TrainStep(m, _loss_fn, topt.AdamW(),
                  sharding_plan=MeshPlan(dp=1).sharding_plan())
        with pytest.raises(NotImplementedError, match="item 14d"):
            TrainStep(m, _loss_fn, topt.AdamW(),
                      mesh=build_mesh({"dp": 1, "pp": 2}, devices=[0, 1]))
    finally:
        set_mesh(None)


def test_capture_holds_the_collector_off(monkeypatch):
    """static/capture.py's capture runs its body with Python's cyclic
    collector disabled (a collection there could destroy an earlier
    graph mid-capture) and restores it after, also when the body fails;
    a collector that was off stays off. The CUDA graph calls are stood
    in for, since no card is needed to check this."""
    import contextlib
    import gc
    from paddle_tpu_torch.static import capture as cap

    class FakeGraph:
        def register_generator_state(self, g):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(cap, "count_capture", lambda *a: None)
    seen = []

    def body():
        seen.append(gc.isenabled())
        return 1

    def failing():
        seen.append(gc.isenabled())
        raise RuntimeError("operation not permitted when stream is capturing")

    was = gc.isenabled()
    try:
        gc.enable()
        assert cap.capture(body, "cuda")[1] == 1 and gc.isenabled()
        with pytest.raises(RuntimeError, match="CUDA graph capture failed"):
            cap.capture(failing, "cuda")
        assert gc.isenabled()
        gc.disable()
        cap.capture(body, "cuda")
        assert not gc.isenabled()
    finally:
        (gc.enable if was else gc.disable)()
    assert seen == [False, False, False]
