"""The port's telemetry planes (paddle_tpu_torch/observability) against the
JAX package's, and their wiring into the port's engine, scheduler and
TrainStep.

Each copied plane gets the same sequence of calls through the JAX module
and the port's; the results must be equal once timestamps, pids and hosts
are normalised: metrics.snapshot, the Prometheus exposition, reqtrace's
timelines/attribute/explain_tail and the BurnMeter's burn, the
timeseries rate on an injected clock, the decision ledger's JSON, the
flight-recorder dump and the watchdog firing on a stalled step clock.
Then the port's f32 engine and the JAX engine serve one trace with the
planes armed and count the same serving counters and spans. The memory
plane's OOM sentry runs on canned torch OOM messages and exceptions.

Every test leaves each gate as it found it and resets what it filled
(tier-1 runs -n 6 --dist loadfile: later files in a worker share module
state). The disabled paths are shown to do nothing by counting calls to
the record functions, never by timing them.
"""
import json
import re

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu.observability import decisions as j_dec
from paddle_tpu.observability import exporters as j_exp
from paddle_tpu.observability import flight_recorder as j_fr
from paddle_tpu.observability import metrics as j_met
from paddle_tpu.observability import reqtrace as j_rt
from paddle_tpu.observability import timeseries as j_ts
from paddle_tpu.observability import watchdog as j_wd
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, load_jax_params
from paddle_tpu_torch.observability import decisions as t_dec
from paddle_tpu_torch.observability import exporters as t_exp
from paddle_tpu_torch.observability import flight_recorder as t_fr
from paddle_tpu_torch.observability import memory as t_mem
from paddle_tpu_torch.observability import metrics as t_met
from paddle_tpu_torch.observability import pulse_server as t_pulse
from paddle_tpu_torch.observability import reqtrace as t_rt
from paddle_tpu_torch.observability import sentinel as t_sent
from paddle_tpu_torch.observability import timeseries as t_ts
from paddle_tpu_torch.observability import watchdog as t_wd
from paddle_tpu_torch.serving import ServingConfig, ServingEngine

JAX = dict(met=j_met, exp=j_exp, rt=j_rt, ts=j_ts, dec=j_dec, fr=j_fr,
           wd=j_wd)
PORT = dict(met=t_met, exp=t_exp, rt=t_rt, ts=t_ts, dec=t_dec, fr=t_fr,
            wd=t_wd)
GATED = (j_met, j_rt, j_fr, j_ts, j_dec, t_met, t_rt, t_fr, t_ts, t_dec)
PREFIX = "obs_parity."


@pytest.fixture(autouse=True)
def planes():
    """Every gate back as it was, every ring emptied, and the
    instruments a test made dropped from both registries again."""
    saved = [(m, m._enabled) for m in GATED]
    before = {met: set(met._REGISTRY) for met in (j_met, t_met)}
    yield
    for m in (j_ts, t_ts):
        m.disable()
        m.reset()
    for m in (j_rt, t_rt, j_fr, t_fr, j_dec, t_dec):
        m.reset()
    for m, on in saved:
        m._enabled = on
    for met, keys in before.items():
        with met._reg_lock:
            for key in set(met._REGISTRY) - keys:
                del met._REGISTRY[key]


def _norm(x, key=None):
    """Floats to 0.0 and hosts/pids/paths to markers: what is left must
    match between the two packages."""
    if isinstance(x, dict):
        return {k: _norm(v, k) for k, v in x.items()
                if k not in ("host", "pid", "path")}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, float):
        return 0.0
    if key == "decision_id" or (isinstance(x, str)
                                and re.fullmatch(r"d\d+-\d+-\d+", x)):
        return "d"
    return x


def _both(fn):
    return fn(JAX), fn(PORT)


# -- metrics and exporters ----------------------------------------------------

def _metric_calls(p):
    met = p["met"]
    met.enable()
    met.counter(PREFIX + "calls", op="matmul").add(3)
    met.counter(PREFIX + "calls", op="matmul").add(2)
    met.counter(PREFIX + "calls", op="add").add(1)
    met.gauge(PREFIX + "depth").set(7)
    met.gauge(PREFIX + "depth").add(2)
    met.gauge(PREFIX + "mode").set("drain")
    h = met.histogram(PREFIX + "ms", bucket=16)
    for v in np.linspace(0.5, 40.0, 301):
        h.observe(float(v))
    met.histogram(PREFIX + "ms", bucket=32).observe_many([1.0, 2.0, 3.0])
    met.disable()
    met.counter(PREFIX + "calls", op="matmul").add(100)   # gated off
    met.counter(PREFIX + "always", _always=True).add(4)   # not gated
    snap = met.snapshot(PREFIX)
    return snap, p["exp"].to_prometheus(snap), met.get(
        PREFIX + "calls", op="matmul").value()


def test_metrics_snapshot_and_prometheus_equal_jax():
    (j_snap, j_text, j_v), (t_snap, t_text, t_v) = _both(_metric_calls)
    assert t_snap == j_snap and len(t_snap) == 7
    assert t_text == j_text and t_exp.validate_exposition(t_text) > 0
    assert t_v == j_v == 5


def test_exporters_reports_and_trace_marks_equal_jax():
    report = {"train": {"tokens_per_s": 1.5e5, "steps": 12},
              "serving": {"ttft_ms": {"p50": 3.25, "p99": 9.5}}}
    flat = t_exp.flatten_report(report)
    assert flat == j_exp.flatten_report(report)
    assert t_exp.unflatten_report(flat) == j_exp.unflatten_report(flat)
    j_snap, t_snap = _both(lambda p: _metric_calls(p)[0])
    assert t_exp.chrome_trace_events(t_snap, ts_us=5.0) == \
        j_exp.chrome_trace_events(j_snap, ts_us=5.0)


# -- reqtrace -----------------------------------------------------------------

def _trace_calls(p):
    rt = p["rt"]
    rt.reset()
    rt.enable()
    for i in range(6):
        rid = f"r{i}"
        t = 10.0 + i
        rt.mark(rid, "submit", t=t)
        rt.mark(rid, "dispatch", t=t + 0.01, replica=0)
        rt.record_span(rid, "admission", t + 0.01, t + 0.02 + 0.1 * i)
        rt.record_span(rid, "prefill", t + 0.02 + 0.1 * i, t + 0.05 + 0.1 * i,
                       bucket=16, width=2, replica=0, tick=i)
        rt.record_span(rid, "decode", t + 0.05 + 0.1 * i, t + 0.5 + 0.3 * i,
                       bucket=4, chunk=2, replica=0, tick=i)
        rt.mark(rid, "retire", t=t + 0.5 + 0.3 * i, reason="length",
                replica=0)
    tl = rt.timelines()
    burn = rt.BurnMeter(budget=0.1, windows=(5.0, 60.0))
    for k in range(40):
        burn.record(100.0 + k, breached=(k % 7 == 0))
    return (tl, [rt.attribute(tl[r]) for r in sorted(tl)],
            rt.explain_tail(), rt.chrome_trace_events(),
            burn.rates(now=140.0), burn.alert(now=140.0))


def test_reqtrace_timelines_attribution_tail_and_burn_equal_jax():
    j_out, t_out = _both(_trace_calls)
    assert t_out == j_out
    assert t_out[2]["dominant_overall"] == "decode"


# -- timeseries ---------------------------------------------------------------

def _pulse_calls(p):
    met, ts = p["met"], p["ts"]
    ts.reset()
    ts.enable(cadence_s=1.0, capacity=64)
    met.enable()
    c = met.counter(PREFIX + "tokens")
    g = met.gauge(PREFIX + "queue")
    h = met.histogram(PREFIX + "step_ms")
    for k in range(6):
        c.add(5 * (k + 1))
        g.set(float(k % 3))
        h.observe(2.0 + k)
        ts.sample(now=100.0 + 2 * k, force=True)
    ts.sample(now=110.5)               # inside the cadence: throttled
    key = PREFIX + "tokens"
    return (ts.rate(key, now=110.0), ts.rate(key, window=4.0, now=110.0),
            ts.gauge_stats(PREFIX + "queue", now=110.0),
            ts.hist_delta(PREFIX + "step_ms", now=110.0),
            ts.series(key, now=110.0), ts.keys(PREFIX))


def test_timeseries_rate_on_an_injected_clock_equals_jax():
    j_out, t_out = _both(_pulse_calls)
    assert t_out == j_out
    assert t_out[0] == pytest.approx((105 - 5) / 10.0)


# -- decisions ----------------------------------------------------------------

def _ledger_calls(p, path):
    dec = p["dec"]
    dec.reset()
    a = dec.record("supervisor", "evict", "stall>limit",
                   {"rank": 3, "age_s": 12.5}, signals={"p99_ttft_ms": 80.0},
                   settle_s=5.0, clock=1000.0)
    dec.observe("supervisor", {"p99_ttft_ms": 40.0}, clock=1003.0)
    dec.record("serving", "scale_up", "burn>1", {"burn": 2.0},
               signals={"tokens_per_s": 100.0},
               post_signals={"tokens_per_s": 180.0}, clock=1004.0)
    dec.join_outcomes(now=1010.0)
    doc = dec.dump(path=str(path))
    with open(path) as f:
        on_disk = json.load(f)
    return a is not None, dec.outcome_counts(), _norm(doc), _norm(on_disk)


def test_decision_ledger_json_equals_jax(tmp_path):
    j_out = _ledger_calls(JAX, tmp_path / "j.json")
    t_out = _ledger_calls(PORT, tmp_path / "t.json")
    assert t_out == j_out
    assert t_out[1] and len(t_out[3]["records"]) == 2


# -- flight recorder and watchdog ---------------------------------------------

def _recorder_calls(p, path):
    fr = p["fr"]
    fr.reset()
    fr.enable(sync_steps=False)
    for step in range(3):
        tok = fr.step_begin("train_step", step)
        fr.record("loss_scale.skip", step=step, scale=2.0 ** 15)
        fr.step_end("train_step", step, tok)
    fr.collective_seq("dp", "all_reduce")
    fr.record("oom", program="serving_decode", requested_bytes=1 << 30)
    doc = fr.dump(path=str(path), reason="manual", stacks=False)
    with open(path) as f:
        on_disk = json.load(f)
    fr.disable()
    return _norm(doc), _norm(on_disk), fr.seq_table()


def test_flight_recorder_dump_equals_jax(tmp_path):
    j_out = _recorder_calls(JAX, tmp_path / "j.json")
    t_out = _recorder_calls(PORT, tmp_path / "t.json")
    assert t_out == j_out
    kinds = [e["k"] for e in t_out[0]["events"]]
    assert kinds.count("step.begin") == kinds.count("step.end") == 3


def _stall(p, tmp_path, monkeypatch):
    fr, wd = p["fr"], p["wd"]
    fr.reset()
    fr.enable(sync_steps=False)
    clock = [50.0]
    monkeypatch.setattr(fr.time, "monotonic", lambda: clock[0])
    monkeypatch.setattr(wd.time, "monotonic", lambda: clock[0])
    for step in range(4):
        tok = fr.step_begin("train_step", step)
        clock[0] += 0.5
        fr.step_end("train_step", step, tok)
    seen = []
    dog = wd.HangWatchdog(min_timeout=2.0, timeout_factor=2.0,
                          peer_poke=False, dump_dir=str(tmp_path),
                          on_stall=seen.append)
    dog._check_progress()              # 0 s since the last step: quiet
    clock[0] += 1.9
    dog._check_progress()              # inside the limit
    fired_early = dog.stall_count
    clock[0] += 5.0                    # the step clock stalls
    dog._check_progress()
    dog._check_progress()              # one dump per episode
    fr.disable()
    ev = [e for e in fr.get_recorder().events()
          if e["k"] == "watchdog.stall"]
    return (fired_early, dog.stall_count, dog.timeout(), len(seen),
            seen[0]["reason"], _norm(ev))


def test_watchdog_fires_on_a_stalled_step_clock_like_jax(tmp_path,
                                                         monkeypatch):
    j_out = _stall(JAX, tmp_path / "j", monkeypatch)
    t_out = _stall(PORT, tmp_path / "t", monkeypatch)
    assert t_out == j_out
    assert t_out[:2] == (0, 1) and t_out[4] == "watchdog_stall"


# -- the memory plane's OOM sentry --------------------------------------------

NEW_MSG = ("CUDA out of memory. Tried to allocate 20.00 GiB. GPU 0 has a "
           "total capacity of 79.11 GiB of which 3.44 GiB is free. Including "
           "non-PyTorch memory, this process has 75.66 GiB memory in use.")
OLD_MSG = ("CUDA out of memory. Tried to allocate 2.00 MiB (GPU 0; 15.78 GiB "
           "total capacity; 12.00 GiB already allocated; 1.50 GiB free; "
           "13.10 GiB reserved in total by PyTorch)")
GIB, MIB = 2 ** 30, 2 ** 20


@pytest.mark.parametrize("msg,req,free,limit", [
    (NEW_MSG, 20 * GIB, int(3.44 * GIB), int(79.11 * GIB)),
    (OLD_MSG, 2 * MIB, int(1.5 * GIB), int(15.78 * GIB)),
    ("RESOURCE_EXHAUSTED: while trying to allocate 1.50GiB", int(1.5 * GIB),
     None, None),
    ("something else broke", None, None, None)])
def test_parse_oom_reads_torch_messages(msg, req, free, limit):
    assert t_mem.parse_oom(msg) == {"requested_bytes": req,
                                    "free_bytes": free, "limit_bytes": limit}


@pytest.mark.parametrize("exc,oom", [
    (torch.cuda.OutOfMemoryError(NEW_MSG), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 8.00 MiB"), True),
    (MemoryError("paged cache exhausted"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: out of HBM"), True),
    (RuntimeError("zoom lens mushroom"), False),
    (ValueError("bad shape"), False)])
def test_is_oom(exc, oom):
    assert t_mem.is_oom(exc) is oom


def test_handle_dispatch_oom_writes_a_receipt_and_counts(tmp_path):
    t_fr.reset()
    t_fr.enable(sync_steps=False)
    counter = t_met.counter("memory.oom_total", _always=True,
                            program="serving_decode")
    before = counter.value()
    path = tmp_path / "oom.json"
    doc = t_mem.handle_dispatch_oom(
        "serving_decode", torch.cuda.OutOfMemoryError(NEW_MSG),
        receipt_path=str(path), bucket=16, step=7)
    assert counter.value() == before + 1
    on_disk = json.loads(path.read_text())
    assert on_disk["requested_bytes"] == 20 * GIB
    assert on_disk["free_bytes"] == int(3.44 * GIB)
    assert on_disk["bucket"] == 16 and on_disk["top_scope"] is None
    assert "serving shapes" in on_disk["hint"]
    assert doc["receipt_path"] == str(path)
    crumbs = [e for e in t_fr.get_recorder().events() if e["k"] == "oom"]
    assert crumbs and crumbs[-1]["program"] == "serving_decode"
    # not an OOM: nothing recorded
    assert t_mem.handle_dispatch_oom("serving_decode",
                                     ValueError("x")) is None
    assert counter.value() == before + 1


def test_device_memory_stats_without_cuda_is_empty_and_sample_is_gated():
    t_met.disable()
    assert t_mem.sample() is None
    t_met.enable()
    doc = t_mem.sample()
    assert doc["host_rss_bytes"] > 0
    if not torch.cuda.is_initialized():
        assert doc["devices"] == [] == t_mem.device_memory_stats()


# -- the wiring ---------------------------------------------------------------

V = 97
F32 = dict(max_slots=4, max_admit=2, block_size=4, n_blocks=32,
           prefill_buckets=(8, 16), max_total_tokens=32, decode_chunk=2,
           dtype=None)
TRACE = [(7, 8), (3, 6), (11, 5), (2, 7), (9, 4)]


def _pair(seed, layers=2, hidden=32, heads=4):
    paddle.seed(seed)
    jm = JaxGPT(JaxConfig(vocab_size=V, hidden_size=hidden,
                          num_layers=layers, num_heads=heads, max_seq_len=64,
                          dropout=0.0, use_flash_attention=False))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(vocab_size=V, hidden_size=hidden,
                                  num_layers=layers, num_heads=heads,
                                  max_seq_len=64, dropout=0.0),
                        device="cpu").eval()
    return jm, load_jax_params(tm, state)


@pytest.fixture(scope="module")
def pairs():
    return _pair(3), _pair(7, layers=1, hidden=16, heads=2)


def _prompts(shared):
    rng = np.random.RandomState(4)
    head = rng.randint(0, V, (8,))
    out = []
    for L, _ in TRACE:
        p = rng.randint(0, V, (L,))
        if shared:
            p = np.concatenate([head, p])[:max(L, 9)]
        out.append(p.astype(np.int32))
    return out


def _serve(eng, prompts, p):
    """A staggered trace with the planes armed; returns the streams, the
    serving counters and each request's spans."""
    met, rt = p["met"], p["rt"]
    met.reset("serving.")
    rt.reset()
    met.enable()
    rt.enable()
    rids = [f"q{i}" for i in range(len(prompts))]
    eng.submit(prompts[0], TRACE[0][1], rid=rids[0])
    eng.step()
    eng.submit(prompts[1], TRACE[1][1], rid=rids[1])
    eng.step()
    for i in range(2, len(prompts)):
        eng.submit(prompts[i], TRACE[i][1], rid=rids[i])
    done = {r.rid: list(r.out) for r in eng.run_to_completion()}
    met.disable()
    rt.disable()
    snap = met.snapshot("serving.")
    names = ("tokens_total", "retired_total", "admitted_total",
             "prefix_hits_total", "spec_proposed_total",
             "spec_accepted_total")
    counts = {n: snap.get(f"serving.{n}", {}).get("value", 0)
              for n in names}
    hists = {n: snap[f"serving.{n}"]["count"]
             for n in ("ttft_ms", "prefill_ms", "decode_step_ms")}
    spans = {}
    for ev in rt.get_tracer().events():
        key = (ev.get("comp") or ev.get("mark"), ev.get("bucket"),
               ev.get("width"), ev.get("chunk"), ev.get("tick"))
        spans.setdefault(ev["rid"], []).append(key)
    return ([done[r] for r in rids], counts, hists,
            {r: sorted(v, key=repr) for r, v in spans.items()})


@pytest.mark.parametrize("lever", ["plain", "speculative", "prefix_sharing"])
def test_engine_counters_and_spans_equal_the_jax_engine(pairs, lever):
    (jm, tm), (jd, td) = pairs
    kw, jkw, tkw = {}, {}, {}
    if lever == "speculative":
        kw = dict(speculative_k=2)
        jkw, tkw = dict(draft_model=jd), dict(draft_model=td)
    elif lever == "prefix_sharing":
        kw = dict(prefix_sharing=True)
    prompts = _prompts(lever == "prefix_sharing")
    j_out = _serve(JaxServingEngine(jm, JaxServingConfig(**dict(F32, **kw)),
                                    **jkw).warmup(), prompts, JAX)
    t_out = _serve(ServingEngine(tm, ServingConfig(**dict(F32, **kw)),
                                 **tkw).warmup(), prompts, PORT)
    assert t_out[0] == j_out[0]
    assert t_out[1] == j_out[1]
    assert t_out[2] == j_out[2]
    assert t_out[3] == j_out[3]
    counts = t_out[1]
    emitted = sum(len(s) for s in t_out[0])
    assert counts["retired_total"] == counts["admitted_total"] == len(TRACE)
    # the first token of each request comes from its prefill
    assert counts["tokens_total"] + counts["admitted_total"] == emitted
    if lever == "speculative":
        assert counts["spec_accepted_total"] > 0
    if lever == "prefix_sharing":
        assert counts["prefix_hits_total"] > 0
    for spans in t_out[3].values():
        comps = [s[0] for s in spans]
        for c in ("submit", "dispatch", "admission", "prefill", "decode",
                  "retire"):
            assert c in comps


def test_disabled_planes_record_nothing(pairs, monkeypatch):
    """With every plane off the engine calls no metrics instrument and no
    tracer record function (counted, not timed)."""
    (_, tm), _ = pairs
    eng = ServingEngine(tm, ServingConfig(**F32)).warmup()
    calls = []
    for fn in ("counter", "gauge", "histogram"):
        monkeypatch.setattr(t_met, fn, lambda *a, **k: calls.append(a))
    tracer = t_rt.get_tracer()
    monkeypatch.setattr(tracer, "record_span",
                        lambda *a, **k: calls.append(a))
    monkeypatch.setattr(tracer, "mark", lambda *a, **k: calls.append(a))
    t_met.disable()
    t_rt.disable()
    outs = eng.generate_tokens(_prompts(False)[:3], [4, 3, 5])
    assert [len(o) for o in outs] == [4, 3, 5]
    assert calls == []


def test_engine_dispatch_oom_propagates_with_its_receipt(pairs, monkeypatch,
                                                         tmp_path):
    (_, tm), _ = pairs
    monkeypatch.setenv("PD_OOM_DIR", str(tmp_path))
    eng = ServingEngine(tm, ServingConfig(**F32)).warmup()

    def boom(*a, **k):
        raise torch.cuda.OutOfMemoryError(NEW_MSG)

    monkeypatch.setattr(eng, "_decode", boom)
    counter = t_met.counter("memory.oom_total", _always=True,
                            program="serving_decode")
    before = counter.value()
    eng.submit(np.arange(5, dtype=np.int32), 4)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        eng.step()
    assert counter.value() == before + 1
    receipts = list(tmp_path.glob("oom_serving_decode_rank*_pid*.json"))
    assert len(receipts) == 1
    doc = json.loads(receipts[0].read_text())
    assert doc["bucket"] == 4 and doc["step"] == 1


def _tiny_step(scaler=None):
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.static import TrainStep
    torch.manual_seed(0)
    layer = torch.nn.Linear(8, 4)
    opt = SGD(learning_rate=0.1, parameters=list(layer.parameters()))
    return TrainStep(layer, lambda out, y: ((out - y) ** 2).mean(), opt,
                     scaler=scaler)


def test_train_step_brackets_counts_and_sentinel_metric(monkeypatch):
    step = _tiny_step()
    x, y = torch.randn(6, 8), torch.randn(6, 4)
    t_fr.reset()
    t_fr.enable(sync_steps=True)
    t_met.enable()
    for _ in range(3):
        step(x, y)
    t_fr.disable()
    kinds = [(e["k"], e.get("step")) for e in t_fr.get_recorder().events()
             if e["k"].startswith("step.")]
    assert kinds == [("step.begin", 0), ("step.end", 0), ("step.begin", 1),
                     ("step.end", 1), ("step.begin", 2), ("step.end", 2)]
    assert t_met.get("train.steps_total").value() == 3
    # a new signature is a new program: the always-on rollup counts it
    rolled = t_met.counter("train_recompiles_total", _always=True)
    before = rolled.value()
    t_fr.reset()
    t_fr.enable(sync_steps=False)
    step(torch.randn(3, 8), torch.randn(3, 4))
    assert rolled.value() == before + 1
    crumbs = [e for e in t_fr.get_recorder().events()
              if e["k"] == "recompile"]
    assert crumbs and crumbs[0]["engine"] == "train"


def test_train_step_reads_the_scale_only_with_a_plane_armed(monkeypatch):
    from paddle_tpu_torch.amp import GradScaler
    step = _tiny_step(GradScaler(init_loss_scaling=2.0 ** 10))
    x, y = torch.randn(6, 8), torch.randn(6, 4)
    reads = []
    real = torch.Tensor.__float__

    def counting_float(self):
        reads.append(1)
        return real(self)

    monkeypatch.setattr(torch.Tensor, "__float__", counting_float)
    t_met.disable()
    t_fr.disable()
    step(x, y)
    assert reads == []
    t_met.enable()
    step(x, y)
    assert reads and t_met.get("amp.loss_scale.scale").value() == 2.0 ** 10
    # an overflow: the skip counter and the breadcrumb
    t_fr.reset()
    t_fr.enable(sync_steps=False)
    skipped = t_met.counter("amp.loss_scale.skipped_total", _always=True)
    before = skipped.value()
    step(x * float("inf"), y)
    assert skipped.value() == before + 1
    assert [e for e in t_fr.get_recorder().events()
            if e["k"] == "loss_scale.skip"]


def test_train_step_dispatch_oom_propagates(monkeypatch, tmp_path):
    monkeypatch.setenv("PD_OOM_DIR", str(tmp_path))
    step = _tiny_step()

    def boom(*a, **k):
        raise torch.cuda.OutOfMemoryError(NEW_MSG)

    monkeypatch.setattr(step, "_dispatch", boom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        step(torch.randn(2, 8), torch.randn(2, 4))
    assert list(tmp_path.glob("oom_train_step_rank*_pid*.json"))


def test_count_capture_feeds_the_odometer_and_goodput():
    from paddle_tpu_torch.observability import goodput as t_gp
    c = t_met.counter("cuda_graph.captures_total", _always=True,
                      program="generate")
    before = c.value()
    t_gp.reset()
    t_gp.start()
    t_sent.count_capture("generate", 0.25)
    assert c.value() == before + 1
    assert t_gp.accrued("compile") == pytest.approx(0.25)
    assert t_met.get("cuda_graph.capture_secs").count() >= 1
    t_gp.reset()


def test_pulse_server_answers_metrics_on_port_0():
    import urllib.request
    t_met.enable()
    t_met.counter("serving.tokens_total").add(11)
    srv = t_pulse.PulseServer(port=0).start()
    try:
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as r:
            text = r.read().decode()
    finally:
        srv.stop()
    assert "paddle_tpu_serving_tokens_total 11" in text
    assert t_exp.validate_exposition(text) > 0
