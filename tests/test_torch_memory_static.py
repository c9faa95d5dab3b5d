"""The static half of the port's memory plane
(paddle_tpu_torch/observability/memory.py): a TrainStep traced from
shapes alone (TrainStep.aot_lower, a meta-device twin) under the
storage-following dispatch mode, on the CPU.

- The meta trace allocates nothing and leaves the step untouched; its
  temp peak and bytes by scope equal those of the same trace over a
  real eager step of the CPU (the same ops make the same storages; the
  flash-attention Function counts its outputs, not the plain version's
  work, as a kernel's).
- The table has the JAX module's shape: shares over the temp peak sum to
  1.0, arguments by parameter scope (the JAX sentry's scope_of_param
  map, so the parameter rows equal the JAX package's bytes of the same
  model's parameters by scope), peak = arguments + temp peak.
- The attribution is registered: an OOM post-mortem of the program
  names its top scope and the JAX remediation hint for it; publish and
  format_table give the JAX gauges and layout.
- With a scaler, O1 and the sentry the twin runs the whole body.
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import ErnieConfig as JaxConfig
from paddle_tpu.models import ErnieForPretraining as JaxErnie
from paddle_tpu.observability import memory as jmem
from paddle_tpu.observability import sentry as jsentry
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp, optimizer as topt
from paddle_tpu_torch.models import ErnieConfig, ErnieForPretraining
from paddle_tpu_torch.observability import memory as tmem
from paddle_tpu_torch.observability import metrics as pmetrics
from paddle_tpu_torch.observability import sentry as tsentry
from paddle_tpu_torch.static import TrainStep


@pytest.fixture(autouse=True)
def _cpu():
    pt.set_device("cpu")
    pmetrics.reset()
    yield
    pmetrics.reset()


def _step(**kw):
    """A tiny ERNIE TrainStep without dropout: its attention takes the
    flash-attention Function on the CPU, the kernels' route the meta
    trace takes (training-mode attention dropout on the CPU takes the
    blockwise tier instead)."""
    pt.seed(0)
    m = ErnieForPretraining(ErnieConfig.tiny(
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0),
        device="cpu").train()
    return TrainStep(m, lambda o, y: ErnieForPretraining.pretraining_loss(
        o, y), topt.AdamW(learning_rate=1e-3), **kw)


def _batch():
    rng = np.random.RandomState(0)
    return (torch.from_numpy(rng.randint(0, 1024, (2, 32))),
            torch.from_numpy(rng.randint(0, 1024, (2, 32))))


class _Real:
    """A lowered-step stand-in over the real CPU step: its eager body
    and its own tensors."""

    def __init__(self, step, x, y):
        self.step, self.x, self.y = step, x, y
        self._low = step.aot_lower(x, y)

    def arguments(self):
        st = self.step
        out = {k: v for k, v in st.layer.state_dict(keep_vars=True).items()}
        for name, state in zip(st._param_names, st.optimizer_states()):
            out.update({f"{name}/{k}": v for k, v in state.items()})
        out.update({f"strategy/{k}": v for k, v in
                    st.strategy_state.items()})
        out.update({"input/0": self.x, "label/0": self.y})
        return out

    def run(self):
        return self.step.eager_step(self.x, self.y, seed=0)


def test_meta_trace_equals_the_real_cpu_trace():
    x, y = _batch()
    step = _step()
    before = {k: v.clone() for k, v in step.layer.state_dict().items()}
    meta = tmem.train_step_memory(step, x, y, program="meta_step")
    for k, v in step.layer.state_dict().items():
        assert torch.equal(v, before[k]), k          # untouched
    real = tmem.program_memory("real_step", _Real(step, x, y))
    assert meta["total_bytes"] == real["total_bytes"] > 0
    assert {k: r["bytes"] for k, r in meta["scopes"].items()} == \
        {k: r["bytes"] for k, r in real["scopes"].items()}
    assert meta["arguments"] == real["arguments"]
    assert meta["peak_bytes"] == meta["arguments"]["total_bytes"] + \
        meta["total_bytes"]


def test_table_shape_and_parameter_rows_match_jax():
    x, y = _batch()
    step = _step()
    res = tmem.train_step_memory(step, x, y)
    assert set(res) >= {"scopes", "total_bytes", "unattributed_share",
                        "memory", "peak_bytes", "arguments"}
    assert math.isclose(sum(r["share"] for r in res["scopes"].values()),
                        1.0)
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "peak_bytes"):
        assert key in res["memory"]
    # the parameters' bytes by scope, as the JAX package's map sorts the
    # same model's parameters (4 bytes an element)
    paddle.seed(0)
    jm = JaxErnie(JaxConfig.tiny(hidden_dropout_prob=0.0,
                                 attention_probs_dropout_prob=0.0))
    want = {}
    for name, p in jm.state_dict().items():
        if not p.stop_gradient:
            sc = jsentry.scope_of_param(name)
            want[sc] = want.get(sc, 0) + int(np.prod(p.shape)) * 4
    got = {}
    for name, p in step.layer.named_parameters():
        sc = tsentry.scope_of_param(name)
        got[sc] = got.get(sc, 0) + p.numel() * 4
    assert got == want
    # the arguments hold the parameters, AdamW's two moments each, the
    # buffers and the batch
    params = sum(p.numel() * 4 for p in step.params)
    assert res["arguments"]["total_bytes"] >= 3 * params


def test_oom_receipt_names_the_top_scope():
    x, y = _batch()
    res = tmem.train_step_memory(_step(), x, y, program="train_step")
    assert tmem.attribution_of("train_step") is res
    err = RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB. "
                       "GPU 0 has a total capacity of 79.11 GiB of which "
                       "1.50 GiB is free.")
    doc = tmem.oom_postmortem("train_step", err)
    top = [n for n in res["scopes"] if n != "unattributed"][0]
    assert doc["top_scope"] == top
    assert doc["hint"] == jmem.remediation_hint("train_step", top)
    assert doc["top_scopes"][0]["scope"] == list(res["scopes"])[0]
    assert doc["peak_bytes_static"] == res["peak_bytes"]
    assert tmem.oom_postmortem("never_lowered", err)["top_scope"] is None


def test_publish_and_format_follow_jax():
    x, y = _batch()
    res = tmem.train_step_memory(_step(), x, y, publish_gauges=True,
                                 program="p")
    snap = pmetrics.snapshot()
    for name in res["scopes"]:
        assert f"memory.temp_share{{program=p,scope={name}}}" in snap
    assert snap["memory.peak_bytes{program=p}"]["value"] == \
        res["peak_bytes"]
    text = tmem.format_table(res)
    assert text.splitlines()[0].startswith("memory anatomy: peak ")
    assert "arguments (" in text
    assert jmem.format_table(res).splitlines()[1:] == text.splitlines()[1:]


def test_the_twin_runs_the_whole_body():
    x, y = _batch()
    step = _step(amp_level="O1", scaler=amp.GradScaler(),
                 sentry=tsentry.NumericSentry())
    low = step.aot_lower(x, y)
    loss = low.run()
    assert loss.device.type == "meta" and loss.shape == ()
    args = low.arguments()
    assert all(t.device.type == "meta" for t in args.values())
    assert "strategy/amp_scale" in args and "strategy/sentry_fp" in args
    res = tmem.train_step_memory(step, x, y, lowered=low)
    assert {"optimizer", "loss_scale"} <= set(res["scopes"])
    # the real step's state is untouched by the trace
    assert int(step.strategy_state["sentry_step"]) == 0
    assert step.optimizer._step_count == 0
