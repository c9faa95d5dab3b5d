"""The port's open-loop load generator (paddle_tpu_torch/serving/loadgen.py)
against the JAX package's, on the CPU.

synthetic_trace draws the same trace field for field from the same
seed, with and without a class mix and a shared prefix; summarize gives
the same stats for the same records. Each replay runs one trace through
both packages on a tiny f32 GPT (vocab 97, hidden 32, 2 layers,
paddle.seed(3), carried into the port by name): the continuous engine,
the static batches through generate with ragged prompts, and a two-replica
fleet. Every request's greedy tokens must be equal, and so must the
receipts' keys (the port's static receipt adds program_captures).
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu import serving as jserving
from paddle_tpu.serving import loadgen as jlg
from paddle_tpu_torch import serving as pserving
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, load_jax_params
from paddle_tpu_torch.serving import loadgen as plg

SMALL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=64, dropout=0.0)
F32 = dict(max_slots=4, max_admit=2, block_size=4, n_blocks=48,
           prefill_buckets=(24,), max_total_tokens=24, decode_chunk=2,
           dtype=None)
TRACE = dict(rate_rps=2000.0, prompt_len_choices=(3, 5, 8, 11),
             new_token_choices=(2, 4, 7))


@pytest.fixture(scope="module")
def models():
    paddle.seed(3)
    jm = JaxGPT(JaxConfig(use_flash_attention=False, **SMALL))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(**SMALL), device="cpu").eval()
    return jm, load_jax_params(tm, state)


@pytest.mark.parametrize("kw", [
    {}, dict(class_mix={"interactive": 0.5, "batch": 0.5}),
    dict(shared_prefix_len=6, shared_frac=0.5, rate_rps=7.0)])
def test_synthetic_trace_field_for_field(kw):
    a = jlg.synthetic_trace(40, 50304, seed=0, **kw)
    b = plg.synthetic_trace(40, 50304, seed=0, **kw)
    assert len(a) == len(b) == 40
    for x, y in zip(a, b):
        assert x.arrival_s == y.arrival_s
        assert x.max_new_tokens == y.max_new_tokens and x.cls == y.cls
        assert x.ids.dtype == y.ids.dtype and np.array_equal(x.ids, y.ids)


def test_summarize_same_records():
    rng = np.random.RandomState(5)
    for classes in (None, ["interactive", "batch"]):
        recs = []
        for i in range(17):
            a = float(rng.rand())
            f = a + float(rng.rand())
            cls = None if classes is None else classes[i % 2]
            recs.append((a, f, f + float(rng.rand()),
                         int(rng.randint(1, 9)), cls))
        want = jlg.summarize([jlg._Record(*r) for r in recs])
        got = plg.summarize([plg._Record(*r) for r in recs])
        assert got == want
    assert plg.summarize([]) == jlg.summarize([])


def _collect_steps(engine, sink):
    step = engine.step

    def wrapped():
        done = step()
        sink.extend(done)
        return done
    engine.step = wrapped


def test_replay_continuous_tokens_and_receipt(models):
    jm, tm = models
    trace = plg.synthetic_trace(10, 97, seed=2, **TRACE)
    jtrace = jlg.synthetic_trace(10, 97, seed=2, **TRACE)
    outs = {}
    for name, pkg, lg, model, tr in (
            ("jax", jserving, jlg, jm, jtrace),
            ("port", pserving, plg, tm, trace)):
        eng = pkg.ServingEngine(model, pkg.ServingConfig(**F32))
        done = []
        _collect_steps(eng, done)
        stats = lg.replay_continuous(eng, tr)
        outs[name] = (stats, {r.rid: [int(t) for t in r.out] for r in done})
    (js, jtok), (ps, ptok) = outs["jax"], outs["port"]
    assert set(ps) == set(js)
    assert ps["requests"] == js["requests"] == 10
    assert ps["total_new_tokens"] == js["total_new_tokens"]
    assert ps["recompile_events"] == 0
    assert ps["executables"] == ps["expected_executables"]
    assert sorted(ptok.values()) == sorted(jtok.values())
    assert len(ptok) == 10
    budgets = sorted(it.max_new_tokens for it in trace)
    assert sorted(len(v) for v in ptok.values()) == budgets


def _collect_generate(model, sink):
    gen = model.generate

    def wrapped(ids, max_new_tokens, dtype=None, prompt_lens=None):
        out = gen(ids, max_new_tokens=max_new_tokens, dtype=dtype,
                  prompt_lens=prompt_lens)
        arr = np.asarray(out.numpy())
        lens = np.asarray(prompt_lens.numpy())
        sink.append((arr, int(np.asarray(ids.numpy()).shape[1]), lens))
        return out
    model.generate = wrapped
    return gen


def test_replay_static_tokens_and_receipt(models):
    jm, tm = models
    trace = plg.synthetic_trace(9, 97, seed=4, **TRACE)
    jtrace = jlg.synthetic_trace(9, 97, seed=4, **TRACE)
    res = {}
    for name, lg, model, tr in (("jax", jlg, jm, jtrace),
                                ("port", plg, tm, trace)):
        calls = []
        _collect_generate(model, calls)
        try:
            stats = lg.replay_static(model, tr, batch_size=4)
        finally:
            del model.generate
        res[name] = (stats, calls)
    (js, jcalls), (ps, pcalls) = res["jax"], res["port"]
    assert set(ps) == set(js) | {"program_captures"}
    assert ps["compiled_signatures"] == js["compiled_signatures"]
    assert ps["requests"] == js["requests"] == 9
    assert ps["program_captures"] == 0      # the CPU runs the eager loop
    assert len(pcalls) == len(jcalls) == 3
    for (ja, jp, jl), (pa, pp, pl) in zip(jcalls, pcalls):
        assert jp == pp and np.array_equal(jl, pl)
        assert np.array_equal(ja[:, jp:], pa[:, pp:])


def test_replay_fleet_tokens_and_receipt(models, tmp_path):
    jm, tm = models
    mix = {"interactive": 0.5, "batch": 0.5}
    trace = plg.synthetic_trace(8, 97, seed=6, class_mix=mix, **TRACE)
    jtrace = jlg.synthetic_trace(8, 97, seed=6, class_mix=mix, **TRACE)
    res = {}
    for name, pkg, lg, model, tr in (
            ("jax", jserving, jlg, jm, jtrace),
            ("port", pserving, plg, tm, trace)):
        fleet = pkg.ServingFleet(
            model, pkg.ServingConfig(**F32), pkg.ServingSLO(),
            pkg.FleetConfig(replicas=2, min_replicas=1, max_replicas=2,
                            autoscale=False, backoff_base=0.0,
                            receipts_dir=str(tmp_path / name)))
        stats, finished, shed = lg.replay_fleet(fleet, tr)
        res[name] = (stats, sorted(
            (list(map(int, fr.emitted)), fr.finish_reason, fr.cls)
            for fr in finished), len(shed))
    (js, jstreams, jshed), (ps, pstreams, pshed) = res["jax"], res["port"]
    assert set(ps) == set(js)
    assert set(ps["fleet"]) == set(js["fleet"])
    assert pstreams == jstreams and len(pstreams) == 8
    assert pshed == jshed == ps["shed"] == 0
    assert ps["dropped_requests"] == js["dropped_requests"] == 0
    assert set(ps["per_class_ttft_ms"]) == set(js["per_class_ttft_ms"])
