"""The port's numeric-integrity sentry (paddle_tpu_torch/observability/
sentry.py) against the JAX package's, on the CPU.

- In-graph statistics and fingerprints: stats_by_scope and
  fingerprint_tree (torch ops) against the JAX functions under jax.jit
  and against both host twins, on seeded f32, bf16, f16 and int trees:
  nonfinite counts and fingerprints exact, max-abs exact, l2 at 1e-6
  relative (the sums run in different orders); a NaN leaves the
  magnitudes finite (NaN-proofing); bfloat16 leaves are skipped by the
  statistics in both packages (the JAX module's np.inexact test) and
  counted by the fingerprints; one flipped bit changes the fingerprint.
- The monitor: the same observation sequences through both packages'
  SentryMonitor give the same anomalies (spikes only after warm-up),
  health stamps and always-on counters.
- judge_fingerprints on 3 gloo ranks (this file is the ranks' script,
  started by the port's launcher): rank 2 holds one flipped bit; each
  rank's fingerprint of its tree, all-gathered, judged on every rank
  and against the JAX monitor's judgement of the same values.
- The TrainStep: a 2-layer ERNIE with the same weights through the port's
  TrainStep(sentry=) and the JAX TrainStep(sentry=) for 3 steps: each
  step's per-scope statistics of the pre-sync gradients and of the new
  parameters agree at 1e-4 relative (l2 and max-abs; counts exact), and
  each fresh fingerprint equals host_fingerprint of that package's own
  parameters; and the port's parameters after 4 steps with the sentry
  are bit-equal to those without it.
"""
import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"ernie.embeddings.word_embeddings.weight":
            rng.randn(11, 4).astype(np.float32),
            "encoder.0.attention.qkv.weight":
            rng.randn(4, 12).astype(np.float32),
            "encoder.0.ffn_in.weight": rng.randn(4, 8).astype(np.float32),
            "mlm_bias": rng.randn(11).astype(np.float32),
            "step_ids": np.arange(7, dtype=np.int32) - 3}


# -- the rank side: torch and the port only -----------------------------------

def _rank_main(case, out_dir):
    import torch
    import torch.distributed as tdist
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.observability import sentry
    torch.set_num_threads(1)
    pt.set_device("cpu")
    dist.init_parallel_env()
    rank, n = dist.get_rank(), int(os.environ["WORLD_SIZE"])
    tree = {k: torch.from_numpy(v) for k, v in _tree(3).items()}
    if rank == 2:
        # the SDC shape: one mantissa bit of one weight
        w = tree["encoder.0.ffn_in.weight"].view(-1).view(torch.int32)
        w[5] ^= 1 << 3
    fp = int(sentry.fingerprint_tree(tree))
    got = [None] * n
    tdist.all_gather_object(got, fp)
    mon = sentry.SentryMonitor()
    peers = {r: v for r, v in enumerate(got) if r != rank}
    culprit = mon.judge_fingerprints(rank, fp, peers, step=4)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"rank": rank, "fp": fp, "host":
                     sentry.host_fingerprint(tree), "peers": peers,
                     "culprit": culprit,
                     "agreed": mon.last_agreed_probe_step,
                     "anomalies": [a["kind"] for a in mon.anomalies]}, f)


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    _rank_main(sys.argv[1], sys.argv[2])
    sys.exit(0)


# -- the test side ----------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import paddle_tpu as paddle  # noqa: E402
from paddle_tpu.models import ErnieConfig as JaxConfig  # noqa: E402
from paddle_tpu.models import ErnieForPretraining as JaxErnie  # noqa: E402
from paddle_tpu.observability import flight_recorder as jfr  # noqa: E402
from paddle_tpu.observability import metrics as jmetrics  # noqa: E402
from paddle_tpu.observability import sentry as js  # noqa: E402
from paddle_tpu.static import TrainStep as JaxTrainStep  # noqa: E402
import paddle_tpu_torch as pt  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.models import (ErnieConfig, ErnieForPretraining,  # noqa: E402
                                     load_jax_params)
from paddle_tpu_torch.observability import flight_recorder as pfr  # noqa: E402
from paddle_tpu_torch.observability import metrics as pmetrics  # noqa: E402
from paddle_tpu_torch.observability import sentry as ts  # noqa: E402
from paddle_tpu_torch.static import TrainStep  # noqa: E402

NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def _planes():
    pt.set_device("cpu")
    for m, f in ((jmetrics, jfr), (pmetrics, pfr)):
        m.reset()
        f.reset()
    yield
    for m, f in ((jmetrics, jfr), (pmetrics, pfr)):
        m.disable()
        f.disable()
        m.reset()
        f.reset()


def _both(tree):
    """(torch tree, jax tree) of a numpy tree; bfloat16 leaves are given
    as ("bf16", float32 array)."""
    t, j = {}, {}
    for k, v in tree.items():
        if isinstance(v, tuple):
            t[k] = torch.from_numpy(v[1]).to(torch.bfloat16)
            j[k] = jnp.asarray(v[1]).astype(jnp.bfloat16)
        else:
            t[k] = torch.from_numpy(v)
            j[k] = jnp.asarray(v)
    return t, j


@pytest.mark.parametrize("name", [
    "ernie.embeddings.word_embeddings.weight",
    "encoder.layer.0.attention.self.q_proj.weight",
    "encoder.0.ffn_in.weight", "cls.predictions.bias", "mlm_bias",
    "decoder.weight", "blocks.3.mlp.fc1.weight", "w", "pos_emb"])
def test_scope_of_param_matches_jax(name):
    assert ts.scope_of_param(name) == js.scope_of_param(name)


@pytest.mark.parametrize("kind", ["f32", "bf16", "f16_int"])
def test_fingerprint_matches_jax_and_both_hosts(kind):
    tree = _tree(0)
    if kind == "bf16":
        tree["encoder.0.ffn_in.weight"] = (
            "bf16", tree["encoder.0.ffn_in.weight"])
    if kind == "f16_int":
        tree["mlm_bias"] = tree["mlm_bias"].astype(np.float16)
        tree["extra"] = np.arange(-4, 9, dtype=np.int64)
    tt, jt = _both(tree)
    got = int(ts.fingerprint_tree(tt))
    want = int(jax.jit(js.fingerprint_tree)(jt))
    assert got == want
    assert ts.host_fingerprint(tt) == got
    assert js.host_fingerprint({k: np.asarray(v) for k, v in jt.items()}) \
        == want
    flipped = {k: v.clone() for k, v in tt.items()}
    bits = flipped["encoder.0.attention.qkv.weight"].view(-1).view(
        torch.int32)
    bits[3] ^= 1 << 3
    assert int(ts.fingerprint_tree(flipped)) != got


def test_stats_match_jax_with_nan_proofing_and_bf16_skipped():
    tree = _tree(2)
    tree["encoder.0.ffn_in.weight"][0, 0] = np.nan
    tree["encoder.0.ffn_in.weight"][1, 2] = np.inf
    tree["blocks.0.mlp.fc2.weight"] = (
        "bf16", np.random.RandomState(4).randn(3, 3).astype(np.float32))
    tt, jt = _both(tree)
    got = ts.stats_by_scope(tt)
    want = jax.jit(js.stats_by_scope)(jt)
    host = ts.host_stats_by_scope(tt)
    jhost = js.host_stats_by_scope(
        {k: np.asarray(v) for k, v in jt.items()})
    assert set(got) == set(want) == set(host) == set(jhost) \
        == {"attn", "embed", "mlm_head_ce", "mlp"}
    for sc in got:
        for stat in ("nonfinite", "max_abs"):
            assert float(got[sc][stat]) == float(want[sc][stat]) \
                == float(host[sc][stat]) == float(jhost[sc][stat]), (sc,
                                                                     stat)
        np.testing.assert_allclose(float(got[sc]["l2"]),
                                   float(want[sc]["l2"]), rtol=1e-6)
        np.testing.assert_allclose(float(got[sc]["l2"]), host[sc]["l2"],
                                   rtol=1e-6)
    assert int(got["mlp"]["nonfinite"]) == 2
    assert np.isfinite(float(got["mlp"]["max_abs"]))
    assert np.isfinite(float(got["mlp"]["l2"]))


def _feed(mod, seq, cfg):
    mon = mod.SentryMonitor(mod.SentryConfig(**cfg))
    out = []
    for step, stats, kind, loss in seq:
        try:
            flagged = mon.observe(step, stats, kind=kind, loss=loss)
        except mod.NumericFault as e:
            flagged = [dict(e.anomaly, fatal=True)]
        out.append([{k: v for k, v in a.items() if k != "ts"}
                    for a in flagged])
        out.append(mon.health_stamp())
    return out


@pytest.mark.parametrize("case", ["spike_after_warmup", "cold_spike",
                                  "nonfinite_fatal", "param_spike_fatal",
                                  "inf_magnitude"])
def test_monitor_matches_jax(case):
    row = lambda mx, l2=3.0, nf=0: {"other": {  # noqa: E731
        "nonfinite": nf, "max_abs": mx, "l2": l2}}
    cfg = dict(window=8, min_warmup=3, z_threshold=6.0)
    seq = [(s, row(1.0 + 0.01 * s), "grad", 1.0) for s in range(6)]
    if case == "spike_after_warmup":
        seq.append((6, row(1e6), "grad", 1.0))
    elif case == "cold_spike":
        seq = [(0, row(1e6), "grad", 1.0), (1, row(1.0), "grad", 1.0)]
    elif case == "nonfinite_fatal":
        cfg["fatal_nonfinite"] = True
        seq.append((6, row(1.0, nf=3), "grad", float("nan")))
    elif case == "param_spike_fatal":
        cfg["fatal_spike"] = True
        seq += [(s, row(2.0 + 0.01 * s), "param", None) for s in range(6)]
        seq.append((6, row(1e7), "param", None))
    else:
        seq.append((6, row(float("inf")), "grad", 1.0))
    pfr.enable()
    jfr.enable()
    got, want = _feed(ts, seq, cfg), _feed(js, seq, cfg)
    assert got == want
    assert any(got[::2]) == (case != "cold_spike")
    for kind in ("spike", "nonfinite", "loss_nonfinite"):
        assert pmetrics.counter("sentry.anomalies_total", _always=True,
                                kind=kind).value() == jmetrics.counter(
            "sentry.anomalies_total", _always=True, kind=kind).value()
    pk = [e["k"] for e in pfr.get_recorder().events()]
    jk = [e["k"] for e in jfr.get_recorder().events()]
    assert pk.count("sentry.anomaly") == jk.count("sentry.anomaly")


def test_nonfinite_counter_is_always_on():
    assert not pmetrics.enabled()
    mon = ts.SentryMonitor(ts.SentryConfig(min_warmup=3))
    flagged = mon.observe(3, {"attn": {"nonfinite": 2, "max_abs": 1.0,
                                       "l2": 1.0}})
    assert flagged[0]["kind"] == "nonfinite"
    assert pmetrics.counter("sentry.anomalies_total", _always=True,
                            kind="nonfinite").value() == 1
    assert not mon.health_stamp()["healthy"]


def launch_ranks(case, n, out_dir, timeout=120):
    """This file run as `n` gloo ranks by the port's launcher; each
    rank's pickled result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(REPO),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(n), __file__, case, str(out_dir)]
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        log, _ = proc.communicate()
        raise AssertionError(f"{case} on {n} ranks hung\n{log[-4000:]}")
    assert proc.returncode == 0, f"{case} on {n} ranks failed\n{log[-6000:]}"
    out = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def test_judge_fingerprints_names_the_flipped_rank_on_3_gloo_ranks(tmp_path):
    ranks = launch_ranks("judge", 3, tmp_path)
    fps = [r["fp"] for r in ranks]
    assert fps[0] == fps[1] != fps[2]
    for r in ranks:
        assert r["fp"] == r["host"]
        assert r["culprit"] == 2
        assert r["anomalies"] == ["mismatch"]
        # the JAX monitor's judgement of the same values
        mon = js.SentryMonitor()
        assert mon.judge_fingerprints(r["rank"], r["fp"], r["peers"],
                                      step=4) == r["culprit"]
        assert mon.last_agreed_probe_step == r["agreed"]
    # the JAX fingerprint of rank 0's tree is the one the ranks agreed on
    assert js.host_fingerprint(_tree(3)) == fps[0]


class _Keep:
    """A sentry whose consume keeps each step's host values."""
    kept = None

    def consume(self, step, sentry_out):
        self.kept = (self.kept or []) + [self._host(sentry_out)]
        return super().consume(step, sentry_out)


class _PortSentry(_Keep, ts.NumericSentry):
    @staticmethod
    def _host(out):
        return ts.unpack(out)


class _JaxSentry(_Keep, js.NumericSentry):
    @staticmethod
    def _host(out):
        h = jax.device_get(dict(out))
        return {"grad": {s: {k: float(v) for k, v in r.items()}
                         for s, r in h["grad"].items()},
                "param": {s: {k: float(v) for k, v in r.items()}
                          for s, r in h["param"].items()},
                "loss_finite": bool(h["loss_finite"]),
                "fp": int(h["fp"]), "fp_fresh": bool(h["fp_fresh"])}


def _ernie_pair(cfg):
    paddle.seed(0)
    jm = JaxErnie(JaxConfig.tiny(**NO_DROP))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = ErnieForPretraining(ErnieConfig.tiny(**NO_DROP), device="cpu")
    load_jax_params(tm, state)
    jsen, tsen = _JaxSentry(js.SentryConfig(**cfg)), \
        _PortSentry(ts.SentryConfig(**cfg))
    jstep = JaxTrainStep(jm, lambda o, y: JaxErnie.pretraining_loss(o, y),
                         paddle.optimizer.AdamW(learning_rate=1e-3,
                                                weight_decay=0.01),
                         sentry=jsen)
    tstep = TrainStep(tm, lambda o, y: ErnieForPretraining.pretraining_loss(
        o, y), topt.AdamW(learning_rate=1e-3, weight_decay=0.01),
        sentry=tsen)
    return jstep, tstep, jsen, tsen


def test_train_step_sentry_matches_the_jax_train_step():
    torch.set_num_threads(1)
    jstep, tstep, jsen, tsen = _ernie_pair(dict(fingerprint_every=2))
    rng = np.random.RandomState(7)
    for _ in range(3):
        ids = rng.randint(0, 1024, (2, 32)).astype(np.int64)
        lbl = rng.randint(0, 1024, (2, 32)).astype(np.int64)
        jstep(paddle.to_tensor(ids.astype(np.int32)),
              paddle.to_tensor(lbl.astype(np.int32)))
        tstep(torch.from_numpy(ids), torch.from_numpy(lbl))
    assert len(jsen.kept) == len(tsen.kept) == 3
    for i, (j, t) in enumerate(zip(jsen.kept, tsen.kept)):
        for fam in ("grad", "param"):
            assert set(j[fam]) == set(t[fam])
            for sc in j[fam]:
                assert t[fam][sc]["nonfinite"] == j[fam][sc]["nonfinite"]
                for stat in ("max_abs", "l2"):
                    np.testing.assert_allclose(
                        t[fam][sc][stat], j[fam][sc][stat], rtol=1e-4,
                        err_msg=f"step {i} {fam} {sc} {stat}")
        assert t["loss_finite"] == j["loss_finite"] is True
        assert t["fp_fresh"] == j["fp_fresh"] == (i % 2 == 0)
    # the last fresh fingerprint (step 2) is each package's own params'
    own = dict(tstep.layer.named_parameters())
    assert tsen.monitor.last_fingerprint == ts.host_fingerprint(
        {k: own[k] for k in tstep._param_names})
    assert jsen.monitor.last_fingerprint == js.host_fingerprint(
        {k: np.asarray(v) for k, v in jstep.params.items()})
    assert tsen.monitor.last_fingerprint_step == 2
    assert int(tstep.strategy_state["sentry_step"]) == 3
    assert tsen.monitor.health_stamp()["healthy"]


def test_sentry_leaves_the_parameters_bit_equal():
    torch.set_num_threads(1)
    rng = np.random.RandomState(3)
    batches = [(torch.from_numpy(rng.randint(0, 1024, (2, 16))),
                torch.from_numpy(rng.randint(0, 1024, (2, 16))))
               for _ in range(4)]
    runs = []
    for sen in (None, ts.NumericSentry(ts.SentryConfig(
            fingerprint_every=2))):
        pt.seed(5)
        m = ErnieForPretraining(ErnieConfig.tiny(), device="cpu").train()
        step = TrainStep(m, lambda o, y: ErnieForPretraining.
                         pretraining_loss(o, y),
                         topt.AdamW(learning_rate=1e-3), sentry=sen)
        for i, (x, y) in enumerate(batches):
            step(x, y, seed=10 + i)
        runs.append({k: p.detach().clone() for k, p in
                     m.named_parameters()})
        assert ("sentry_step" in step.strategy_state) == (sen is not None)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k


def test_set_state_dict_reseeds_the_sentry_keys():
    pt.seed(0)
    m = ErnieForPretraining(ErnieConfig.tiny(), device="cpu")
    step = TrainStep(m, lambda o, y: ErnieForPretraining.pretraining_loss(
        o, y), topt.AdamW(learning_rate=1e-3),
        sentry=ts.NumericSentry())
    state = step.state_dict()
    del state["strategy_state"]["sentry_step"]
    step.set_state_dict(state)
    assert int(step.strategy_state["sentry_step"]) == 0
    assert "sentry_fp" in step.strategy_state


def test_fault_capture_round_trips(tmp_path):
    params = {"w": torch.randn(3, 2), "b": torch.randn(2).bfloat16()}
    path = ts.write_fault_capture(str(tmp_path / "f.npz"), params,
                                  {"x": np.ones((2, 3))},
                                  observed={"reason": "r"}, step=4, rank=1)
    doc = ts.load_fault_capture(path)
    assert doc["step"] == 4 and doc["rank"] == 1
    assert doc["observed"] == {"reason": "r"}
    np.testing.assert_array_equal(doc["params"]["w"], params["w"].numpy())
    np.testing.assert_array_equal(doc["params"]["b"],
                                  params["b"].float().numpy())
    jdoc = js.load_fault_capture(path)
    assert sorted(jdoc["params"]) == sorted(doc["params"])
