"""The port's host-driven pipeline (distributed/pipeline_engine.py,
pipeline.py, ERNIE's stages, Fleet.build_pipeline) against the JAX
package's dispatch engine.

Same numpy inputs on both sides; each port stage takes its JAX twin's
weights by name (models/convert.py load_jax_params). The JAX engine runs
with mesh=None on the host devices. Tolerances, each for its reason:
- schedules, tick tables and bubble fractions: equal (pure Python);
- losses over 3 steps at 1e-5 relative and parameters after them at
  1e-4 absolute (MLP: 1e-5): f32 on both sides, the frameworks sum in
  another order, and Adam(W) amplifies a difference where sqrt(v) ~ eps
  (tests/test_torch_training.py's reasons). Adam(W) is blind to a
  constant factor on the gradient, so each engine comparison also runs
  with Momentum, whose step is proportional to it: a wrong loss scale or
  microbatch count in the update shows there;
- eval outputs and stage forwards at 1e-5;
- the remat backward's gradients against an autograd pass that kept the
  forward's graph: 1e-6 relative to the largest gradient (the same f32
  ops; autograd accumulates the split and the whole pass in another
  order).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import pipeline_engine as jpe
from paddle_tpu.distributed import pipeline as jpipe
from paddle_tpu.models import ErnieConfig as JaxConfig
from paddle_tpu.models import ernie_pipeline_stages as jax_stages

import paddle_tpu_torch as pt
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import amp, optimizer as topt
from paddle_tpu_torch.core.generator import fold_seed, seed_scope
from paddle_tpu_torch.distributed import pipeline as tpipe
from paddle_tpu_torch.distributed import pipeline_engine as tpe
from paddle_tpu_torch.distributed.fleet import base as pfleet
from paddle_tpu_torch.models import ErnieConfig, ernie_pipeline_stages
from paddle_tpu_torch.models import load_jax_params

PP = tpe.PipelineParallel


@pytest.fixture
def on_cpu():
    """The current device set to the CPU (build_pipeline has no device
    argument: its engine runs where the fleet's process does), restored
    after."""
    from paddle_tpu_torch.core import place
    prev = place._current_place
    pt.set_device("cpu")
    yield
    place._current_place = prev


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """tier-1 runs several pytest workers on one CPU: torch on one
    thread keeps its small ops from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- schedules

GRID = [(2, 4), (4, 8), (3, 3), (1, 2), (4, 2)]


@pytest.mark.parametrize("policy", ["1f1b", "fthenb"])
@pytest.mark.parametrize("S,M", GRID)
def test_1f1b_builder_equals_jax(S, M, policy):
    got = tpe.build_1f1b_schedule(S, M, policy)
    assert got == jpe.build_1f1b_schedule(S, M, policy)
    assert sorted(got) == sorted(set(got)) and len(got) == 2 * S * M


@pytest.mark.parametrize("p,v,M", [(4, 2, 8), (4, 2, 16), (4, 4, 8),
                                   (2, 2, 4), (2, 3, 6), (1, 2, 2)])
def test_interleaved_builder_and_bubble_equal_jax(p, v, M):
    got, fin = tpe.build_interleaved_schedule(p, v, M, return_finish=True)
    want, wfin = jpe.build_interleaved_schedule(p, v, M,
                                                return_finish=True)
    assert got == want and fin == wfin
    ticks, bubble = tpe.simulate_schedule(got, p)
    assert (ticks, bubble) == jpe.simulate_schedule(want, p)
    assert bubble == pytest.approx((p - 1) / (v * M + p - 1), abs=1e-9)
    assert tpe.tick_table(got, p) == jpe.tick_table(want, p)


@pytest.mark.parametrize("policy", ["1f1b", "fthenb"])
@pytest.mark.parametrize("S,M", [(4, 8), (2, 4), (3, 3)])
def test_tick_tables_and_bubble_equal_jax(S, M, policy):
    sched = tpe.build_1f1b_schedule(S, M, policy)
    got, R, Rb = tpe._spmd_tick_tables(sched, S, M)
    want, wR, wRb = jpe._spmd_tick_tables(sched, S, M)
    assert (R, Rb) == (wR, wRb)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    ident = lambda s: s  # noqa: E731
    assert tpe.simulate_schedule(sched, S, dev_of=ident) == \
        jpe.simulate_schedule(sched, S, dev_of=ident)
    if policy == "1f1b":
        _, bubble = tpe.simulate_schedule(sched, S, dev_of=ident)
        assert bubble == pytest.approx((S - 1) / (M + S - 1), abs=1e-9)


def test_interleaved_needs_divisible_micro():
    with pytest.raises(ValueError, match="num_micro"):
        tpe.build_interleaved_schedule(4, 2, 6)


def test_min_slots_equals_jax():
    iv = {0: (1, 5), 1: (2, 6), 2: (6, 9), 3: (7, 12), 4: (10, 13)}
    assert tpipe._min_slots(iv) == jpipe._min_slots(iv)


# ------------------------------------------------------------------ MLP

class _Seq(pt.nn.Layer):
    """nn.Sequential's naming (children "0", "1", ...) over port layers."""

    def __init__(self, *mods):
        super().__init__(device="cpu")
        for i, m in enumerate(mods):
            self.add_module(str(i), m)

    def forward(self, x):
        for m in self.children():
            x = m(x)
        return x


def _jax_mlp(dims):
    paddle.seed(5)
    out = []
    for i, (a, b) in enumerate(dims):
        relu = i < len(dims) - 1
        out.append(jnn.Sequential(jnn.Linear(a, b), jnn.ReLU()) if relu
                   else jnn.Sequential(jnn.Linear(a, b)))
    return out


def _state(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _port_twins(jstages, make):
    out = []
    for j in jstages:
        t = make(j)
        load_jax_params(t, _state(j))
        out.append(t)
    return out


def _port_mlp(jstages):
    def make(j):
        mods = []
        for lyr in j.children():
            if isinstance(lyr, jnn.Linear):
                w = lyr.weight.shape
                mods.append(pt.nn.Linear(w[0], w[1], device="cpu"))
            else:
                mods.append(torch.nn.ReLU())
        return _Seq(*mods)
    return _port_twins(jstages, make)


def _jmse(o, y):
    return JF.mse_loss(o, y)


def _tmse(o, y):
    return ((o - y) ** 2).mean()


def _opts(name, lr):
    """The same optimizer on both sides: (JAX, port)."""
    if name == "momentum":
        return (paddle.optimizer.Momentum(learning_rate=lr, momentum=0.9),
                topt.Momentum(learning_rate=lr, momentum=0.9))
    cls = {"adam": "Adam", "adamw": "AdamW"}[name]
    return (getattr(paddle.optimizer, cls)(learning_rate=lr),
            getattr(topt, cls)(learning_rate=lr))


MLP3 = [(8, 16), (16, 16), (16, 4)]
MLP4 = [(8, 16), (16, 16), (16, 16), (16, 4)]


def _data(rng_seed, b, din, dout):
    rng = np.random.RandomState(rng_seed)
    return (rng.randn(b, din).astype(np.float32),
            rng.randn(b, dout).astype(np.float32))


def _assert_params_equal(jstages, tstages, atol):
    for j, t in zip(jstages, tstages):
        own = t.state_dict()
        for k, v in _state(j).items():
            np.testing.assert_allclose(own[k].numpy(), v, atol=atol,
                                       rtol=atol, err_msg=k)


@pytest.mark.parametrize("opt", ["adam", "momentum"])
@pytest.mark.parametrize("schedule", ["1f1b", "fthenb", "interleaved"])
def test_mlp_engine_matches_jax(schedule, opt):
    """3 MLP stages (interleaved: 4 stages, 2 virtual per rank) over 4
    microbatches with Adam or Momentum: losses over 3 steps, then every
    parameter."""
    dims, v = (MLP4, 2) if schedule == "interleaved" else (MLP3, 1)
    js = _jax_mlp(dims)
    ts = _port_mlp(js)
    jopt, topt_ = _opts(opt, 1e-2)
    jpp = jpe.PipelineParallel(js, _jmse, jopt, num_micro=4,
                               schedule=schedule, virtual_pipeline_degree=v)
    tpp = PP(ts, _tmse, topt_, num_micro=4, schedule=schedule,
             virtual_pipeline_degree=v, device="cpu")
    x, y = _data(0, 8, 8, 4)
    for _ in range(3):
        jl = float(jpp.train_batch(paddle.to_tensor(x),
                                   paddle.to_tensor(y)).numpy())
        tl = float(tpp.train_batch(torch.from_numpy(x), torch.from_numpy(y)))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tpp.last_dispatch_count == jpp.last_dispatch_count
    assert tpp.schedule_bubble_fraction == jpp.schedule_bubble_fraction
    jpp.sync_to_layers()
    _assert_params_equal(js, ts, 1e-5)


def test_eval_batch_matches_jax():
    js = _jax_mlp(MLP3)
    ts = _port_mlp(js)
    jpp = jpe.PipelineParallel(js, _jmse, paddle.optimizer.SGD(
        learning_rate=1e-2), num_micro=2)
    tpp = PP(ts, _tmse, topt.SGD(learning_rate=1e-2), num_micro=2,
             device="cpu")
    x, _ = _data(3, 4, 8, 4)
    got = tpp.eval_batch(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), jpp.eval_batch(
        paddle.to_tensor(x)).numpy(), rtol=1e-5, atol=1e-6)
    assert tpp.last_dispatch_count == 3


@pytest.mark.parametrize("opt", ["adam", "momentum"])
def test_scaler_skipped_step_matches_jax(opt):
    """A GradScaler batch, an overflowing one (inf input: the update is
    gated off on the device, the scale halves) and a clean one: losses,
    the scale and every parameter as the JAX engine's; the dispatches
    count S + 1 overflow checks. Under Momentum a gradient left scaled
    by 2^8 would move the parameters 256 times too far."""
    from paddle_tpu.amp import GradScaler as JScaler
    js = _jax_mlp(MLP3)
    ts = _port_mlp(js)
    jopt, topt_ = _opts(opt, 1e-2)
    jpp = jpe.PipelineParallel(js, _jmse, jopt, num_micro=2)
    tpp = PP(ts, _tmse, topt_, num_micro=2, device="cpu")
    jsc, tsc = JScaler(init_loss_scaling=2.0 ** 8), \
        amp.GradScaler(init_loss_scaling=2.0 ** 8)
    x, y = _data(4, 4, 8, 4)
    bad = x.copy()
    bad[0, 0] = np.inf
    for i, xb in enumerate((x, bad, x)):
        jl = float(jpp.train_batch(paddle.to_tensor(xb), paddle.to_tensor(y),
                                   scaler=jsc).numpy())
        before = [p.detach().clone() for st in tpp.stages for p in st.params]
        tl = float(tpp.train_batch(torch.from_numpy(xb), torch.from_numpy(y),
                                   scaler=tsc))
        if i == 1:
            assert not np.isfinite(tl) and not np.isfinite(jl)
            after = [p for st in tpp.stages for p in st.params]
            assert all(torch.equal(a, b) for a, b in zip(before, after))
        else:
            np.testing.assert_allclose(tl, jl, rtol=1e-5)
        assert tsc.get_loss_scaling() == jsc.get_loss_scaling()
    assert tsc.get_loss_scaling() == 2.0 ** 7
    assert tpp.last_dispatch_count == jpp.last_dispatch_count == \
        3 * 2 + 2 * 2 + 3 + 3 + 1
    jpp.sync_to_layers()
    _assert_params_equal(js, ts, 1e-5)


def test_telemetry_matches_jax():
    """Metrics and the flight recorder armed: the pipeline.* counters and
    gauges of two batches as the JAX engine's, one step.begin/step.end
    pair a batch; the planes restored and their rings reset after."""
    from paddle_tpu.observability import flight_recorder as jfr
    from paddle_tpu.observability import metrics as jobs
    from paddle_tpu_torch.observability import flight_recorder as tfr
    from paddle_tpu_torch.observability import metrics as tobs
    js = _jax_mlp(MLP3)
    ts = _port_mlp(js)
    jpp = jpe.PipelineParallel(js, _jmse, paddle.optimizer.SGD(
        learning_rate=1e-2), num_micro=2)
    tpp = PP(ts, _tmse, topt.SGD(learning_rate=1e-2), num_micro=2,
             device="cpu")
    x, y = _data(6, 4, 8, 4)
    keys = ("pipeline.steps_total", "pipeline.microbatches_total",
            "pipeline.dispatches_per_step", "pipeline.bubble_fraction")
    snaps = []
    for obs, fr, run in (
            (jobs, jfr, lambda: jpp.train_batch(paddle.to_tensor(x),
                                                paddle.to_tensor(y))),
            (tobs, tfr, lambda: tpp.train_batch(torch.from_numpy(x),
                                                torch.from_numpy(y)))):
        was_obs, was_fr = obs._enabled, fr._enabled
        obs.reset("pipeline.")
        fr.reset()
        obs.enable(True)
        fr.enable(True)
        try:
            run()
            run()
            snap = obs.snapshot("pipeline.")
            kinds = [e["k"] for e in fr.get_recorder().events()
                     if e.get("engine") == "pipeline"]
        finally:
            obs.enable(was_obs)
            fr.enable(was_fr)
            obs.reset("pipeline.")
            fr.reset()
        snaps.append({k: snap[k]["value"] for k in keys})
        assert kinds == ["step.begin", "step.end"] * 2
        assert snap["pipeline.step_ms"]["count"] == 2
        assert snap["pipeline.tick_ms"]["count"] == 2 * 2 * 3 * 2
    assert snaps[0] == snaps[1]


@pytest.mark.parametrize("S,M", [(3, 4), (4, 8), (1, 3)])
def test_dispatch_count(S, M):
    ts = _port_mlp(_jax_mlp([(8, 8)] * (S - 1) + [(8, 4)]))
    tpp = PP(ts, _tmse, topt.SGD(learning_rate=1e-3), num_micro=M,
             device="cpu")
    x, y = _data(0, 2 * M, 8, 4)
    tpp.train_batch(torch.from_numpy(x), torch.from_numpy(y))
    assert tpp.last_dispatch_count == S * M + (S - 1) * M + S
    assert len(tpp.last_tick_ms) == 2 * S * M


@pytest.mark.parametrize("policy", ["1f1b", "fthenb"])
def test_in_flight_bound(policy):
    """1F1B holds at most min(M, S - s) stage inputs at stage s;
    F-then-B holds all M."""
    S, M = 4, 8
    ts = _port_mlp(_jax_mlp([(8, 8)] * (S - 1) + [(8, 4)]))
    tpp = PP(ts, _tmse, topt.SGD(learning_rate=1e-3), num_micro=M,
             schedule=policy, device="cpu")
    x, y = _data(1, 2 * M, 8, 4)
    tpp.train_batch(torch.from_numpy(x), torch.from_numpy(y))
    want = [min(M, S - s) if policy == "1f1b" else M for s in range(S)]
    assert tpp.last_in_flight == want


# ----------------------------------------------------------------- ERNIE

def _tiny(**kw):
    cfg = dict(vocab_size=96, hidden_size=32, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=64,
               max_position_embeddings=16, hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, use_flash_attention=False)
    cfg.update(kw)
    return cfg


def _ernie_pair(cfg, S):
    paddle.seed(3)
    js = jax_stages(JaxConfig(**cfg), S)
    ts = ernie_pipeline_stages(ErnieConfig(**cfg), S, device="cpu")
    for j, t in zip(js, ts):
        load_jax_params(t, _state(j))
    return js, ts


def _jce(out, labels):
    logits, _ = out
    return JF.cross_entropy(logits.reshape([-1, logits.shape[-1]]),
                            labels.reshape([-1]))


def _tce(out, labels):
    logits, _ = out
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def _ids(seed, b=4, s=8, vocab=96):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (b, s)).astype(np.int64),
            rng.randint(0, vocab, (b, s)).astype(np.int64))


def _ernie_run(cfg, S, M, schedule="1f1b", v=1, mask=None, steps=3,
               scale=None, opt="adamw"):
    """Both engines over `steps` batches (a GradScaler at init scale
    `scale` on each side when given; AdamW at 5e-3 or Momentum at 0.1):
    losses at 1e-5, then every parameter at 1e-4."""
    from paddle_tpu.amp import GradScaler as JScaler
    js, ts = _ernie_pair(cfg, S)
    jopt, topt_ = _opts(opt, 0.1 if opt == "momentum" else 5e-3)
    jpp = jpe.PipelineParallel(js, _jce, jopt, num_micro=M,
                               schedule=schedule, virtual_pipeline_degree=v)
    tpp = PP(ts, _tce, topt_, num_micro=M, schedule=schedule,
             virtual_pipeline_degree=v, device="cpu")
    jsc = JScaler(init_loss_scaling=scale) if scale else None
    tsc = amp.GradScaler(init_loss_scaling=scale) if scale else None
    ids, lbl = _ids(1)
    jin = (paddle.to_tensor(ids.astype(np.int32)),)
    tin = (torch.from_numpy(ids),)
    if mask is not None:
        jin += (paddle.to_tensor(mask),)
        tin += (torch.from_numpy(mask),)
    for _ in range(steps):
        jl = float(jpp.train_batch(jin, paddle.to_tensor(
            lbl.astype(np.int32)), scaler=jsc).numpy())
        tl = float(tpp.train_batch(tin, torch.from_numpy(lbl), scaler=tsc))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    jpp.sync_to_layers()
    _assert_params_equal(js, ts, 1e-4)
    return jpp, tpp, js, ts


@pytest.mark.parametrize("S,scan", [(1, False), (3, False), (2, True)])
def test_stage_split_and_forward_equal_jax(S, scan):
    """ernie_pipeline_stages splits like the JAX one (the one-stage
    _Solo, the scanned stacks under their JAX names) and each stage's
    forward, chained, equals the JAX stages'."""
    cfg = _tiny(num_hidden_layers=4, scan_layers=scan)
    js, ts = _ernie_pair(cfg, S)
    assert [type(t).__name__ for t in ts] == [type(j).__name__ for j in js]
    assert [sorted(t.state_dict()) for t in ts] == \
        [sorted(j.state_dict()) for j in js]
    ids, _ = _ids(4)
    x, jx = (torch.from_numpy(ids),), (paddle.to_tensor(ids.astype(np.int32)),)
    with torch.no_grad():
        for t, j in zip(ts, js):
            x, jx = t(*x), j(*jx)
            x = x if isinstance(x, tuple) else (x,)
            jx = jx if isinstance(jx, tuple) else (jx,)
    for a, b in zip(x, jx):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("schedule,S,v,opt", [
    ("1f1b", 2, 1, "adamw"), ("fthenb", 2, 1, "adamw"),
    ("interleaved", 2, 2, "adamw"), ("1f1b", 2, 1, "momentum"),
    ("interleaved", 2, 2, "momentum")])
def test_ernie_engine_matches_jax(schedule, S, v, opt):
    """ERNIE's stages (embeddings on the first, the heads on the last)
    over 2 microbatches, AdamW or Momentum: 3 steps' losses, then every
    parameter. The interleaved case runs 2 virtual stages on one rank."""
    jpp, tpp, _, _ = _ernie_run(_tiny(), S, 2, schedule, v, opt=opt)
    assert tpp.last_dispatch_count == jpp.last_dispatch_count


@pytest.mark.parametrize("opt", ["adamw", "momentum"])
def test_moe_stages_aux_loss_matches_jax(opt):
    """Both blocks MoE, under a GradScaler (scale 2^8): stage 0's aux
    loss joins through its remat backward (cotangent = the loss scale),
    stage 1's through the last op; losses and parameters as the JAX
    engine's, under AdamW and under Momentum (which would show a
    gradient left scaled)."""
    cfg = _tiny(moe_num_experts=4, moe_top_k=2, moe_every_n_layers=1)
    jpp, tpp, _, ts = _ernie_run(cfg, 2, 2, scale=2.0 ** 8, opt=opt)
    assert tpp.last_dispatch_count == jpp.last_dispatch_count == \
        2 * 2 + 2 + 2 + 2 + 1
    for st in ts:
        aux = st.pipeline_local_loss()
        assert aux is not None and aux.dim() == 0 and float(aux.detach()) > 0


def test_attention_mask_threads_through_stages():
    """The additive mask is built once in stage 0 and passed on as the
    activation tuple's second element, which carries no gradient; the
    engine with a padded batch trains as the JAX engine does."""
    mask = np.ones((4, 8), np.float32)
    mask[:, 5:] = 0.0
    _, tpp, js, ts = _ernie_run(_tiny(), 2, 2, mask=mask, steps=2)
    assert tpp.stages[0].diff_out == (True, False)
    assert tpp.stages[1].diff_in == (True, False)
    ids, _ = _ids(2)
    with torch.no_grad():
        h = ts[0](torch.from_numpy(ids), torch.from_numpy(mask))
        assert isinstance(h, tuple) and len(h) == 2
        out = ts[1](*h)
        plain = ts[1](ts[0](torch.from_numpy(ids)))
    jh = js[0](paddle.to_tensor(ids.astype(np.int32)), paddle.to_tensor(mask))
    jout = js[1](*jh)
    np.testing.assert_allclose(out[0].numpy(), jout[0].numpy(), atol=1e-5,
                               rtol=1e-5)
    assert not np.allclose(out[0].numpy()[:, 0], plain[0].numpy()[:, 0])


def test_remat_backward_equals_kept_graph_with_dropout():
    """B recomputes the stage forward under F's seeds: at dropout 0.1 the
    engine's accumulated gradients equal those of an autograd pass that
    kept each microbatch's whole graph, its stages drawing the seeds of
    the same (stage, microbatch); another step seed moves them."""
    cfg = _tiny(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    ids, lbl = _ids(5)
    ids_t, lbl_t = torch.from_numpy(ids), torch.from_numpy(lbl)

    def engine_grads(seed):
        pt.seed(0)
        stages = ernie_pipeline_stages(ErnieConfig(**cfg), 2, device="cpu")
        pp = PP(stages, _tce, topt.SGD(learning_rate=0.0), num_micro=2,
                device="cpu")
        pp.train_batch(ids_t, lbl_t, seed=seed)
        return [g.clone() for st in pp.stages for g in st.grads]

    pt.seed(0)
    stages = ernie_pipeline_stages(ErnieConfig(**cfg), 2, device="cpu")
    for m in range(2):
        sl = slice(2 * m, 2 * m + 2)
        with seed_scope(fold_seed(9, (0, m))):
            h = stages[0](ids_t[sl])
        with seed_scope(fold_seed(9, (1, m))):
            loss = _tce(stages[1](h), lbl_t[sl])
        loss.backward()
    # the NSP head and the pooler take no part in this loss: no grad
    ref = [p.grad if p.grad is not None else torch.zeros_like(p)
           for st in stages for p in st.parameters()]
    got = engine_grads(9)
    scale = max(float(g.abs().max()) for g in ref)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=1e-6 * scale, rtol=0)
    other = engine_grads(10)
    assert any(not torch.allclose(a, b) for a, b in zip(got, other))


# --------------------------------------------------------- fleet, refusals

@pytest.mark.parametrize("schedule,v", [("1f1b", 1), ("fthenb", 1),
                                        ("interleaved", 2)])
def test_fleet_build_pipeline(schedule, v, on_cpu):
    """accumulate_steps is the microbatch count, virtual_pipeline_degree
    comes from pipeline_configs; the engine trains."""
    s = pfleet.DistributedStrategy()
    s.pipeline_configs = dict(s.pipeline_configs, accumulate_steps=4,
                              virtual_pipeline_degree=v)
    dims = MLP4 if v > 1 else MLP3
    ts = _port_mlp(_jax_mlp(dims))
    opt = topt.Adam(learning_rate=1e-2)
    fl = pfleet.Fleet()
    fl.init(strategy=s)
    try:
        eng = fl.build_pipeline(ts, _tmse, fl.distributed_optimizer(opt),
                                strategy=s, schedule=schedule)
    finally:
        from paddle_tpu_torch.distributed import set_mesh
        set_mesh(None)
    assert isinstance(eng, PP) and eng.num_micro == 4
    assert eng.optimizer is opt and eng.virtual_pipeline_degree == v
    assert eng.schedule_policy == schedule
    x, y = _data(2, 8, 8, 4)
    l0 = float(eng.train_batch(torch.from_numpy(x), torch.from_numpy(y)))
    l1 = float(eng.train_batch(torch.from_numpy(x), torch.from_numpy(y)))
    assert np.isfinite([l0, l1]).all() and l1 < l0


def _refusal_cases():
    from paddle_tpu_torch.distributed import build_mesh
    ts = _port_mlp(_jax_mlp(MLP3))
    opt = topt.SGD(learning_rate=1e-3)
    return ts, opt, build_mesh


@pytest.mark.parametrize("kw,item", [
    (dict(exec_mode="spmd_1f1b"), "item 14d"),
    (dict(exec_mode="spmd_1f1b", plan=object()), "item 14d"),
    (dict(sentry=object()), "item 17"),
    (dict(param_spec_fn=lambda n, t: None), "item 14d"),
    (dict(mesh="pp2"), "item 14d"),
    (dict(mesh="dp2"), "item 14d")])
def test_refusals_name_their_item(kw, item):
    ts, opt, build_mesh = _refusal_cases()
    if kw.get("mesh") == "pp2":
        kw["mesh"] = build_mesh({"pp": 2}, devices=[0, 1])
    elif kw.get("mesh") == "dp2":
        kw["mesh"] = build_mesh({"dp": 2}, devices=[0, 1])
    with pytest.raises(NotImplementedError, match=item):
        PP(ts, _tmse, opt, num_micro=2, device="cpu", **kw)


@pytest.mark.parametrize("kw,word", [
    (dict(exec_mode="zero_bubble"), "exec_mode"),
    (dict(plan=object()), "plan="),
    (dict(virtual_pipeline_degree=2), "divisible"),
    (dict(virtual_pipeline_degree=3, schedule="fthenb"), "interleaved"),
    (dict(schedule="gpipe"), "schedule"),
    (dict(mesh="pp1"), "stages")])
def test_constructor_value_errors(kw, word):
    """Every ValueError of the JAX constructor (exec_mode, plan= without
    spmd, v divisibility, v with another schedule), an unknown schedule
    and a pp axis of one rank against 3 stages (the JAX assert)."""
    ts, opt, build_mesh = _refusal_cases()
    if kw.get("mesh") == "pp1":
        kw["mesh"] = build_mesh({"pp": 1, "dp": 1})
    with pytest.raises(ValueError, match=word):
        PP(ts, _tmse, opt, num_micro=2, device="cpu", **kw)


def test_batch_not_divisible_by_num_micro():
    ts, opt, _ = _refusal_cases()
    tpp = PP(ts, _tmse, opt, num_micro=3, device="cpu")
    x, y = _data(0, 4, 8, 4)
    with pytest.raises(ValueError, match="num_micro=3"):
        tpp.train_batch(torch.from_numpy(x), torch.from_numpy(y))


@pytest.mark.parametrize("kw", [dict(), dict(schedule="spmd_1f1b"),
                                dict(schedule="1f1b",
                                     exec_mode="spmd_1f1b"),
                                dict(schedule="1f1b", plan=object())])
def test_fleet_one_program_forms_name_14d(kw):
    with pytest.raises(NotImplementedError, match="item 14d"):
        pfleet.Fleet().build_pipeline([], None, None, **kw)


def test_pipeline_layer_runs_in_turn_and_refuses_a_pp_axis():
    from paddle_tpu_torch.distributed import axis_context
    descs = [tpipe.LayerDesc(pt.nn.Linear, 4, 4, device="cpu")
             for _ in range(4)]
    pl = tpipe.PipelineLayer(descs, num_stages=2, device="cpu")
    assert pl.stage_bounds == [(0, 2), (2, 4)]
    assert len(pl.stage_layers(1)) == 2
    x = torch.randn(2, 4)
    want = x
    for lyr in pl.funcs:
        want = lyr(want)
    torch.testing.assert_close(pl(x), want, rtol=0, atol=0)
    with axis_context("pp"):
        with pytest.raises(RuntimeError, match="item 14d"):
            pl(x)


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine's ops are captured as "
                    "CUDA graphs there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_captured_engine_equals_eager_on_card(card):
    """Tiny ERNIE stages at dropout 0.1 under 1F1B: the captured engine
    (one graph per stage, op kind and signature) bit-equal to the eager
    one over 3 steps, losses and every parameter."""
    cfg = _tiny(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    ids, lbl = _ids(6)
    runs = []
    for eager in (False, True):
        pt.seed(0)
        stages = ernie_pipeline_stages(ErnieConfig(**cfg), 2, device=card)
        pp = PP(stages, _tce, topt.AdamW(learning_rate=1e-3), num_micro=2,
                device=card, eager=eager)
        losses = [pp.train_batch(torch.from_numpy(ids).to(card),
                                 torch.from_numpy(lbl).to(card),
                                 seed=20 + i) for i in range(3)]
        runs.append((torch.stack(losses),
                     [p.detach().clone() for st in pp.stages
                      for p in st.params], pp))
    (gl, gp, gpp), (el, ep, _) = runs
    assert torch.equal(gl, el)
    assert all(torch.equal(a, b) for a, b in zip(gp, ep))
    assert gpp.captures == gpp.programs and gpp.recompile_sentinel.fired == 0
