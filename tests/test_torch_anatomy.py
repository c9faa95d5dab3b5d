"""The port's step anatomy, device-time attribution and profiler
(paddle_tpu_torch/observability/{anatomy,xprof}.py, paddle_tpu_torch/
profiler) against the JAX package's, on the CPU.

- Scopes: the taxonomy, registration and its refusals, the breadcrumb
  once per name, scope_of_op_name on the same paths, the scope stack.
- FLOPs by scope: a two-matmul program under the "mlp" and
  "mlm_head_ce" scopes, its forward and the gradients of its weights,
  in both packages; the port's count_flops per scope equals the JAX
  mini cost model's dot pricing over the JAX program's dot_generals,
  grouped by the JAX scope_of_op_name of their name stacks (exact). On a 2-layer ERNIE TrainStep the
  table's total equals mfu.step_flops of the same step, the mlp row
  equals the analytic count of the ffn matmuls (forward and both
  backward products), the attention row carries the flash kernels'
  registered FLOPs, and every CORE scope of the model is present.
- xprof: the JAX tests' synthetic traces through both packages'
  load_profile and attribute_device_time (equal results), and a trace as
  torch.profiler writes it (kernels under gpu_user_annotation ranges)
  attributed by its ranges.
- profiler: RecordEvent spans, summary, the chrome export, StepClock's
  statistics against the JAX one's on the same step times, and
  start_trace/stop_trace writing a trace load_profile reads.
"""
import gzip
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu import profiler as jprof
from paddle_tpu.observability import anatomy as janat
from paddle_tpu.observability import xprof as jxprof
import paddle_tpu_torch as pt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
from paddle_tpu_torch.observability import anatomy as tanat
from paddle_tpu_torch.observability import flight_recorder as pfr
from paddle_tpu_torch.observability import mfu as tmfu
from paddle_tpu_torch.observability import xprof as txprof
from paddle_tpu_torch.static import TrainStep


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")
    pfr.reset()
    yield
    pfr.disable()
    pfr.reset()


# -- scopes ---------------------------------------------------------------------

def test_taxonomy_and_registration_match_jax():
    assert tanat.CORE_SCOPES == janat.CORE_SCOPES
    assert tanat.register_scope("pp_send") == janat.register_scope(
        "pp_send")
    for bad in ("", "a/b"):
        with pytest.raises(ValueError):
            tanat.register_scope(bad)
        with pytest.raises(ValueError):
            janat.register_scope(bad)
    assert set(janat.CORE_SCOPES) <= tanat.known_scopes()


@pytest.mark.parametrize("path", [
    "jit(step)/jit(main)/transpose(jvp(attn))/mlp/dot",
    "jit(step)/attn/dot_general", "jit(step)/grad_sync/psum",
    "fusion/3/optimizer", "jit(step)/nothing/here", "embed", ""])
def test_scope_of_op_name_matches_jax(path):
    assert tanat.scope_of_op_name(path) == janat.scope_of_op_name(path)


def test_scope_stack_and_breadcrumb_once():
    pfr.enable()
    assert tanat.current_scope() is None
    for _ in range(3):
        with tanat.scope("attn"):
            with tanat.scope("rope_tables"):
                assert tanat.current_scope() == "rope_tables"
            assert tanat.current_scope() == "attn"
    assert tanat.current_scope() is None
    crumbs = [e["name"] for e in pfr.get_recorder().events()
              if e.get("k") == "scope"]
    assert crumbs.count("rope_tables") == 1
    assert "rope_tables" in tanat.known_scopes()


# -- FLOPs by scope ---------------------------------------------------------------

B, I, H, O = 4, 6, 8, 3


def _mats(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, I).astype(np.float32),
            rng.randn(I, H).astype(np.float32),
            rng.randn(H, O).astype(np.float32))


def _jax_dot_flops_by_scope(fn, *args):
    """The JAX package's FLOPs by scope of fn's program: every dot_general
    of its jaxpr priced as the JAX mini cost model prices a dot
    (2 * prod(result) * prod(contracted lhs dims)), under the scope
    janat.scope_of_op_name finds in the equation's name stack (the
    path jax.named_scope writes, transpose(jvp(...)) frames included).
    The compiled HLO text this jax prints carries neither operand
    shapes nor op metadata, so the name stack is read where the JAX
    module's own tracing writes it."""
    def walk(jaxpr, per):
        for e in jaxpr.eqns:
            for v in e.params.values():
                sub = getattr(v, "jaxpr", None)
                if sub is not None:
                    walk(getattr(sub, "jaxpr", sub), per)
            if e.primitive.name != "dot_general":
                continue
            (lc, _), _ = e.params["dimension_numbers"]
            lhs = e.invars[0].aval.shape
            f = 2.0 * np.prod(e.outvars[0].aval.shape) * np.prod(
                [lhs[d] for d in lc])
            sc = janat.scope_of_op_name(str(e.source_info.name_stack)) \
                or "unattributed"
            per[sc] = per.get(sc, 0.0) + float(f)
        return per
    return walk(jax.make_jaxpr(fn)(*args).jaxpr, {})


def test_flops_by_scope_match_the_jax_dot_count():
    x, w1, w2 = _mats()

    def jf(a, b, xx):
        with janat.scope("mlp"):
            h = jnp.tanh(xx @ a)
        with janat.scope("mlm_head_ce"):
            return jnp.mean((h @ b) ** 2)
    want = _jax_dot_flops_by_scope(jax.grad(jf, argnums=(0, 1)), w1, w2,
                                   x)

    ta, tb = (torch.from_numpy(v).requires_grad_() for v in (w1, w2))
    with tanat.count_flops() as counts:
        with tanat.scope("mlp"):
            h = torch.tanh(torch.from_numpy(x) @ ta)
        with tanat.scope("mlm_head_ce"):
            loss = ((h @ tb) ** 2).mean()
        loss.backward()
    assert counts.flops == want
    # the forward and the weight gradient under mlp; the head's forward,
    # its weight gradient and the gradient of h (its node's) under the
    # head
    assert want == {"mlp": 2 * (2 * B * I * H),
                    "mlm_head_ce": 3 * (2 * B * H * O)}
    table = tanat.table(counts)
    assert math.isclose(sum(r["share"] for r in table["scopes"].values()),
                        1.0)


def _ernie_step():
    """A 2-layer ERNIE TrainStep without dropout, so its attention runs
    through the flash-attention Function (the kernels' route on the
    card) on the CPU too."""
    pt.seed(0)
    m = ErnieForPretraining(ErnieConfig.tiny(
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        device="cpu").train()
    return TrainStep(m, lambda o, y: ErnieForPretraining.pretraining_loss(
        o, y), topt.AdamW(learning_rate=1e-3))


def test_train_step_anatomy_sums_to_step_flops_with_the_mlp_count():
    torch.set_num_threads(1)
    step = _ernie_step()
    cfg = step.layer.config
    b, s = 2, 32
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s)))
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s)))
    res = tanat.train_step_anatomy(step, x, y, seed=3)
    total = tmfu.step_flops(step.eager_step, x, y, seed=3)
    assert res["total_flops"] == total
    h, f, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    rows = res["scopes"]
    # ffn_in and ffn_out, forward plus the input and weight gradients
    assert rows["mlp"]["flops"] == L * 3 * (2 * 2 * b * s * h * f)
    heads = cfg.num_attention_heads
    flash = L * 3.5 * 4.0 * b * heads * s * s * (h // heads)
    qkv_proj = L * 3 * (2 * b * s * h * 3 * h + 2 * b * s * h * h)
    assert rows["attn"]["flops"] == qkv_proj + flash
    assert {"attn", "mlp", "mlm_head_ce"} <= set(rows)
    assert math.isclose(sum(r["share"] for r in rows.values()), 1.0)
    assert res["source"] == tanat.EAGER_SOURCE
    text = tanat.format_table(res)
    assert "mlp" in text and "attn" in text


# -- xprof ----------------------------------------------------------------------

def _jax_fixture():
    from test_xprof import _fixture_trace
    return _fixture_trace()


@pytest.mark.parametrize("gz", [False, True])
def test_shared_trace_attributes_as_in_jax(tmp_path, gz):
    path = tmp_path / ("trace.json.gz" if gz else "trace.json")
    doc = _jax_fixture()
    if gz:
        with gzip.open(path, "wt") as f:
            json.dump(doc, f)
    else:
        path.write_text(json.dumps(doc))
    got = txprof.load_profile(str(path))
    want = jxprof.load_profile(str(path))
    assert got == want
    assert txprof.attribute_device_time(got) == \
        jxprof.attribute_device_time(want)
    assert txprof.attribute_device_time(got, steps=2) == \
        jxprof.attribute_device_time(want, steps=2)
    assert txprof.top_ops(got, steps=2) == jxprof.top_ops(want, steps=2)
    assert txprof.format_top_ops(got) == jxprof.format_top_ops(want)
    for name, args in (("all-reduce-start.3", None),
                       ("fusion.9", {"tf_op": "x/fused_allreduce_hier"}),
                       ("fusion.12", {"tf_op": "x/mlp"})):
        assert txprof.is_comm_kernel(name, args) == \
            jxprof.is_comm_kernel(name, args)


def test_directory_and_newest_trace(tmp_path):
    import os
    import time
    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "old.pt.trace.json").write_text(json.dumps(
        {"traceEvents": []}))
    time.sleep(0.01)
    (tmp_path / "a" / "new.pt.trace.json").write_text(json.dumps(
        _jax_fixture()))
    os.utime(tmp_path / "a" / "new.pt.trace.json")
    assert txprof.find_xplane(str(tmp_path)).endswith("new.pt.trace.json")
    assert len(txprof.load_profile(str(tmp_path))) == 4
    with pytest.raises(FileNotFoundError):
        txprof.load_profile(str(tmp_path / "a" / "nothing"))


def test_torch_trace_kernels_take_their_ranges_scope(tmp_path):
    """A trace as torch.profiler writes it: kernels on the card's lanes
    under gpu_user_annotation ranges (the scope record_function
    ranges), host ops and runtime calls beside them. The kernels'
    scopes come from the ranges holding them; the same events with the
    path in their args give the JAX module's result."""
    dev = {"ph": "X", "pid": 0, "tid": 7}
    doc = {"traceEvents": [
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "GPU 0"}},
        {"ph": "M", "pid": 0, "tid": 7, "name": "thread_name",
         "args": {"name": "stream 7"}},
        {"ph": "M", "pid": 4242, "name": "process_name",
         "args": {"name": "python3"}},
        dict(dev, cat="gpu_user_annotation", name="attn", ts=0, dur=120),
        dict(dev, cat="gpu_user_annotation", name="mlp", ts=150, dur=100),
        dict(dev, cat="kernel", name="flash_fwd_wgmma", ts=10, dur=80),
        dict(dev, cat="kernel", name="sm90_gemm", ts=160, dur=60),
        dict(dev, cat="gpu_memcpy", name="Memcpy DtoD", ts=230, dur=10),
        dict(dev, cat="kernel", name="ncclDevKernel_AllReduce", ts=260,
             dur=40),
        {"ph": "X", "pid": 4242, "tid": 1, "cat": "cpu_op",
         "name": "aten::mm", "ts": 150, "dur": 5},
        {"ph": "X", "pid": 4242, "tid": 1, "cat": "cuda_runtime",
         "name": "cudaLaunchKernel", "ts": 152, "dur": 2},
    ]}
    p = tmp_path / "t.pt.trace.json"
    p.write_text(json.dumps(doc))
    evs = txprof.load_profile(str(p))
    assert [e["name"] for e in evs] == ["flash_fwd_wgmma", "sm90_gemm",
                                        "Memcpy DtoD",
                                        "ncclDevKernel_AllReduce"]
    res = txprof.attribute_device_time(evs)
    assert res["per_scope_ms"] == {"attn": pytest.approx(0.08),
                                   "mlp": pytest.approx(0.07),
                                   "comm": pytest.approx(0.04)}
    assert sum(res["per_scope_ms"].values()) == pytest.approx(
        sum(e["dur"] for e in evs) / 1e3)
    assert res["comm"]["exposed_ms"] == pytest.approx(0.04)
    # the JAX module on the same events, the path in their args
    assert jxprof.attribute_device_time(evs) == res


# -- profiler -------------------------------------------------------------------

def test_record_event_summary_and_export_match_jax(tmp_path):
    for mod in (tprof, jprof):
        mod.start_profiler()
        for _ in range(3):
            with mod.RecordEvent("load"):
                pass
        with mod.RecordEvent("step"):
            pass

        @mod.RecordEvent("decorated")
        def f():
            return 7
        assert f() == 7
    got = tprof.stop_profiler(profile_path=str(tmp_path / "t"))
    want = jprof.stop_profiler(profile_path=str(tmp_path / "j"))
    assert list(got) and sorted(got) == sorted(want)
    assert {k: v["calls"] for k, v in got.items()} == \
        {k: v["calls"] for k, v in want.items()}
    assert got.truncated is False
    doc = json.load(open(tmp_path / "t.json"))
    assert sorted({e["name"] for e in doc["traceEvents"]}) == \
        ["decorated", "load", "step"]
    with tprof.RecordEvent("off"):
        pass            # not profiling: no span recorded
    assert "off" not in tprof.summary()


def test_step_clock_matches_jax():
    times = [0.010, 0.012, 0.011, 0.030, 0.009]
    ticks = [1.0, 2.5, 0.5]
    got, want = tprof.StepClock(), jprof.StepClock()
    for clk in (got, want):
        clk.steps_s.extend(times)
        clk.add_ticks(ticks)
    assert got.stats(0.008) == want.stats(0.008)
    assert got.orchestration_fraction(0.02) == \
        want.orchestration_fraction(0.02)
    with got.step():
        pass
    assert len(got.steps_s) == len(times) + 1


def test_start_and_stop_trace_write_what_load_profile_reads(tmp_path):
    d = tprof.start_trace(str(tmp_path / "trace"))
    with tanat.scope("mlp"):
        torch.ones(8) @ torch.ones(8)
    path = tprof.stop_trace()
    assert path.startswith(d) and path.endswith(".pt.trace.json")
    assert txprof.load_profile(d) == txprof.load_profile(path)
    doc = json.load(open(path))
    assert any(e.get("name") == "mlp" for e in doc["traceEvents"])
    with pytest.raises(RuntimeError):
        tprof.stop_trace()
