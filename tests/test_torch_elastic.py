"""The port's elastic supervisor and chaos hooks
(paddle_tpu_torch/distributed/{elastic,chaos}.py and the fleet KV's
heartbeats) against the JAX package's, on the CPU.

Each scenario of tests/test_elastic_supervisor.py (canned doctor
verdicts, injected clocks) runs as one sequence of operations through
both packages' SupervisorPolicy: every Decision (as_dict) and the
state_snapshot() after every operation must be equal. Then the pure
helpers (effective_verdict, translate_verdict_rank), the receipts'
keys and the always-on counters, the doctor bridge (the same verdict
from the same flight-recorder dumps), the chaos plans (parsed the same,
malformed values refused alike) and apply_numeric on numpy arrays and
torch tensors (equal to the JAX package's), and a heartbeat monitor
that names a worker that stopped pulsing.
"""
import json
import time

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import chaos as jchaos
from paddle_tpu.distributed import elastic as jel
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu_torch.distributed import chaos as pchaos
from paddle_tpu_torch.distributed import elastic as pel
from paddle_tpu_torch.observability import metrics as pmetrics

DIVERGENCE = {"kind": "divergence", "rank": 1, "source": "doctor",
              "evidence": {"axis": "dp", "op": "allreduce_sum", "seq": 7}}
HANG = {"kind": "hang", "rank": 2, "source": "doctor",
        "evidence": {"age_s": 42.0}}
STRAGGLER = {"kind": "straggler", "rank": 3, "source": "doctor",
             "evidence": {"vs_fleet_median": 2.1}}
CRASH = [(1, "exit rc=1")]

GANG = dict(world=4, backoff_base=1.0, backoff_factor=2.0)
SERVE = dict(world=4, initial_world=2, policy="rank", allow_shrink=True,
             scale_cooldown_s=5.0, backoff_base=1.0, backoff_factor=2.0)


def slo(p99=500.0, high=4, low=1):
    return ("slo", p99, high, low)


# (policy kwargs, operations): ("decide", failures, verdict, now),
# ("grow", now), ("scale", slo, queued, p99, now, burn), ("progress",
# now), ("respawn", now), ("scale_spawn", now)
SCENARIOS = {
    "divergence_evicts": (dict(GANG, allow_shrink=True),
                          [("decide", CRASH, DIVERGENCE, 0.0)]),
    "hang_evicts": (dict(GANG, allow_shrink=True),
                    [("decide", [(2, "heartbeat stall")], HANG, 0.0)]),
    "straggler_respawns": (dict(GANG, allow_shrink=True),
                           [("decide", [(3, "exit rc=1")], STRAGGLER,
                             0.0)]),
    "no_shrink_gang": (GANG, [("decide", CRASH, DIVERGENCE, 0.0)]),
    "min_world_floor": (dict(GANG, world=2, allow_shrink=True,
                             min_world=2),
                        [("decide", CRASH, DIVERGENCE, 0.0)]),
    "rank_policy": (dict(GANG, policy="rank"),
                    [("decide", [(2, "exit rc=1")], None, 0.0)]),
    "unknown_rank_no_evict": (dict(GANG, allow_shrink=True),
                              [("decide", CRASH, DIVERGENCE, 0.0),
                               ("decide", [(0, "exit rc=1")], DIVERGENCE,
                                1.0)]),
    "backoff_ladder": (dict(GANG, max_restarts=10, backoff_max=5.0),
                       [("decide", CRASH, None, float(i))
                        for i in range(5)]),
    "heal_resets_ladder": (dict(GANG, heal_after_s=10.0),
                           [("decide", CRASH, None, 0.0),
                            ("respawn", 0.0), ("progress", 5.0),
                            ("progress", 11.0),
                            ("decide", CRASH, None, 12.0)]),
    "max_restarts_abort": (dict(GANG, max_restarts=1),
                           [("decide", CRASH, None, 0.0),
                            ("respawn", 0.0),
                            ("decide", CRASH, None, 1.0)]),
    "window_budget": (dict(GANG, max_restarts=100, restart_budget=2,
                           restart_window_s=60.0),
                      [("decide", CRASH, None, 0.0), ("respawn", 0.0),
                       ("decide", CRASH, None, 1.0), ("respawn", 1.0),
                       ("decide", CRASH, None, 2.0),
                       ("decide", CRASH, None, 70.0)]),
    "grow_after_cooldown": (dict(GANG, allow_shrink=True,
                                 grow_after_s=30.0),
                            [("decide", CRASH, DIVERGENCE, 0.0),
                             ("grow", 10.0), ("grow", 31.0)]),
    "grow_deferred_by_budget": (dict(GANG, allow_shrink=True,
                                     grow_after_s=30.0, restart_budget=1,
                                     restart_window_s=60.0,
                                     max_restarts=10),
                                [("decide", CRASH, DIVERGENCE, 0.0),
                                 ("respawn", 0.0), ("grow", 40.0),
                                 ("grow", 41.0), ("grow", 100.0)]),
    "scale_up_queue": (SERVE, [("scale", slo(high=4), 9, 10.0, 0.0,
                                False)]),
    "scale_up_breach": (SERVE, [("scale", slo(p99=100.0), 0, 250.0, 0.0,
                                 False)]),
    "scale_cooldown": (SERVE, [("scale", slo(), 99, 10.0, 0.0, False),
                               ("scale", slo(), 99, 10.0, 5.0 - 1e-3,
                                False),
                               ("scale", slo(), 99, 10.0, 10.0, False)]),
    "scale_flap_budget": (dict(SERVE, restart_budget=1,
                               scale_cooldown_s=0.0),
                          [("scale_spawn", 0.0),
                           ("scale", slo(), 99, 10.0, 1.0, False),
                           ("scale", slo(), 99, 10.0, 61.0, False)]),
    "evicted_slot_not_reused": (SERVE,
                                [("decide", [(1, "exit rc=1")],
                                  {"kind": "crash", "rank": 1,
                                   "source": "supervisor",
                                   "evidence": {}}, 0.0),
                                 ("scale", slo(), 99, 10.0, 1.0, False)]),
    "scale_down_floor": (dict(SERVE, min_world=1, scale_cooldown_s=0.0),
                         [("scale", slo(low=1), 0, -1.0, 0.0, False),
                          ("scale", slo(low=1), 0, 50.0, 1.0, False),
                          ("scale", slo(low=1), 0, 50.0, 2.0, False)]),
    "burn_scales_up": (SERVE, [("scale", slo(p99=500.0, high=100), 0,
                                10.0, 0.0, True)]),
    "burn_vetoes_down": (dict(SERVE, scale_cooldown_s=0.0),
                         [("scale", slo(low=1), 0, 50.0, 0.0, True),
                          ("scale", slo(low=1), 0, 50.0, 1.0, False)]),
    "scale_spawns_keep_crash_budget": (dict(SERVE, max_restarts=1,
                                            scale_cooldown_s=0.0),
                                       [("scale", slo(high=0), 99, 10.0,
                                         float(i), False)
                                        for i in range(3)]
                                       + [("scale_spawn", 3.0),
                                          ("decide", [(0, "exit rc=1")],
                                           None, 100.0)]),
}


class _SLO:
    def __init__(self, p99, high, low):
        self.p99_ttft_ms, self.queue_high, self.queue_low = p99, high, low


def _drive(mod, kw, ops):
    p = mod.SupervisorPolicy(**kw)
    out = []
    for op in ops:
        kind, args = op[0], op[1:]
        d = None
        if kind == "decide":
            d = p.decide(args[0], args[1], now=args[2])
        elif kind == "grow":
            d = p.maybe_grow(now=args[0])
        elif kind == "scale":
            s = _SLO(*args[0][1:])
            d = p.decide_scale(s, args[1], args[2], now=args[3],
                               burn_alert=args[4])
        elif kind == "progress":
            p.note_progress(now=args[0])
        elif kind == "respawn":
            p.record_respawn(now=args[0])
        elif kind == "scale_spawn":
            p.record_scale_spawn(now=args[0])
        out.append((None if d is None else d.as_dict(),
                    None if d is None else d.decision_id is not None,
                    p.state_snapshot()))
    return out, p


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervisor_policy_matches_jax(name):
    kw, ops = SCENARIOS[name]
    want, jp = _drive(jel, kw, ops)
    got, tp = _drive(pel, kw, ops)
    assert got == want
    # a policy rebuilt from its snapshot decides as the live one did
    snap = json.loads(json.dumps(tp.state_snapshot()))
    assert pel.SupervisorPolicy.from_snapshot(snap).state_snapshot() == \
        jel.SupervisorPolicy.from_snapshot(snap).state_snapshot()


@pytest.mark.parametrize("failures,verdict", [
    (CRASH, DIVERGENCE), ([(2, "heartbeat stall")], None),
    ([(1, "exit rc=-9")], None), ([], None),
    ([(1, "exit rc=1")], HANG), ([(2, "heartbeat stall")], HANG),
    ([(3, "exit rc=1")], DIVERGENCE)])
def test_effective_verdict_matches_jax(failures, verdict):
    assert pel.effective_verdict(failures, verdict) == \
        jel.effective_verdict(failures, verdict)


@pytest.mark.parametrize("verdict,ranks", [
    (DIVERGENCE, [0, 2, 3]), (DIVERGENCE, [0, 1, 2, 3]),
    (dict(DIVERGENCE, rank=7), [0, 2]), (None, [0, 1]),
    ({"kind": "none", "rank": None}, [0])])
def test_translate_verdict_rank_matches_jax(verdict, ranks):
    assert pel.translate_verdict_rank(verdict, ranks) == \
        jel.translate_verdict_rank(verdict, ranks)


def test_receipts_carry_the_same_keys_and_counters(tmp_path):
    kw = dict(episode=3, verdict=DIVERGENCE, action="evict_shrink",
              ranks=[1], world_before=4, world_after=3, resume_step=120,
              goodput={"productive_fraction": 0.8}, goodput_delta=-0.05,
              delay_s=2.0, reason="evict rank 1", extras={"x": 1},
              decision_id="d0-1-0")
    docs = []
    for mod, met, sub in ((jel, jmetrics, "jax"), (pel, pmetrics, "port")):
        met.reset()
        doc = mod.emit_receipt(out_dir=str(tmp_path / sub), **kw)
        with open(doc["path"]) as f:
            on_disk = json.load(f)
        snap = met.snapshot(prefix="elastic.")
        met.reset()
        docs.append((on_disk, snap))
    (jd, js), (td, ts) = docs
    assert sorted(td) == sorted(jd)
    for k in jd:
        if k != "ts":
            assert td[k] == jd[k], k
    assert ts == js
    assert ts["elastic.evictions_total"]["value"] == 1


def _dump(d, rank, seq, steps):
    doc = {"version": 1, "reason": "signal:SIGTERM", "ts": 1000.0 + rank,
           "rank": rank, "world": 2, "events": [], "collective_seq": seq,
           "progress": {"steps": steps, "last_step_age_s": 99.0,
                        "step_s_p50": 0.01, "step_s_p99": 0.02},
           "goodput": {"elapsed_seconds": 10.0,
                       "productive_fraction": 0.9}}
    (d / f"flight_signal_SIGTERM_rank{rank}_pid{rank}.json").write_text(
        json.dumps(doc))


def test_collect_diagnosis_matches_jax(tmp_path):
    _dump(tmp_path, 0, {"dp|allreduce_sum": 8}, 12)
    _dump(tmp_path, 1, {"dp|allreduce_sum": 5}, 9)
    got = pel.collect_diagnosis(str(tmp_path))
    want = jel.collect_diagnosis(str(tmp_path))
    assert got["verdict"] == want["verdict"]
    assert got["verdict"]["kind"] == "divergence"
    assert got["verdict"]["rank"] == 1
    for k in ("dumps", "resume_step", "goodput", "evidence_ts"):
        assert got[k] == want[k], k
    empty = tmp_path / "empty"
    empty.mkdir()
    assert pel.collect_diagnosis(str(empty))["verdict"]["kind"] == "none"


@pytest.fixture
def fresh_plans(monkeypatch):
    for var in ("PD_CHAOS_MODE", "PD_CHAOS_STEP", "PD_CHAOS_RANK",
                "PD_CHAOS_EVERY", "PD_CHAOS_STALL_S", "PD_CHAOS_SCOPE",
                "PD_CHAOS_BIT", "PD_CHAOS_SCALE"):
        monkeypatch.delenv(var, raising=False)
    jchaos.reset_plan_cache()
    pchaos.reset_plan_cache()
    yield monkeypatch
    jchaos.reset_plan_cache()
    pchaos.reset_plan_cache()


def _plan_fields(p):
    if p is None:
        return None
    return {k: getattr(p, k) for k in ("mode", "step", "rank", "every",
                                        "stall_s", "scope", "bit",
                                        "scale")}


@pytest.mark.parametrize("env", [
    {}, {"PD_CHAOS_MODE": ""},
    {"PD_CHAOS_MODE": "kill", "PD_CHAOS_STEP": "4", "PD_CHAOS_RANK": "0"},
    {"PD_CHAOS_MODE": "Stall", "PD_CHAOS_STALL_S": "0.5",
     "PD_CHAOS_EVERY": "1"},
    {"PD_CHAOS_MODE": "corrupt_ckpt"},
    {"PD_CHAOS_MODE": "corrupt_swap", "PD_CHAOS_STEP": "2"},
    {"PD_CHAOS_MODE": "flip_bit", "PD_CHAOS_BIT": "3",
     "PD_CHAOS_SCOPE": "w"},
    {"PD_CHAOS_MODE": "scale_grad", "PD_CHAOS_SCALE": "10"},
    {"PD_CHAOS_MODE": "meteor"}, {"PD_CHAOS_MODE": "kill",
                                  "PD_CHAOS_STEP": "five"},
    {"PD_CHAOS_MODE": "flip_bit", "PD_CHAOS_BIT": "40"}])
def test_chaos_plans_parse_the_same(fresh_plans, env):
    for k, v in env.items():
        fresh_plans.setenv(k, v)
    results = []
    for mod in (jchaos, pchaos):
        try:
            results.append(("plan", _plan_fields(mod.plan())))
        except ValueError as e:
            results.append(("error", str(e)))
    assert results[0] == results[1]


def test_chaos_hooks_fire_alike(fresh_plans):
    fresh_plans.setenv("PD_CHAOS_MODE", "corrupt_swap")
    fresh_plans.setenv("PD_CHAOS_STEP", "2")
    fresh_plans.setenv("PD_CHAOS_RANK", "1")
    for mod in (jchaos, pchaos):
        # a serving-only mode never reaches the training stall branch
        assert mod.maybe_inject(2, rank=1, incarnation=0) is None
        assert mod.maybe_inject_serving(2, 1) == "corrupt_swap"
        assert mod.maybe_inject_serving(2, 1, incarnation=1) is None
        assert mod.maybe_inject_serving(3, 1) is None


@pytest.mark.parametrize("mode", ["nan_grad", "flip_bit", "scale_grad"])
def test_apply_numeric_matches_jax_on_numpy_and_tensors(fresh_plans, mode):
    fresh_plans.setenv("PD_CHAOS_MODE", mode)
    fresh_plans.setenv("PD_CHAOS_STEP", "3")
    fresh_plans.setenv("PD_CHAOS_RANK", "0")
    fresh_plans.setenv("PD_CHAOS_SCOPE", "w")
    rng = np.random.RandomState(0)
    tree = {"b": rng.randn(3).astype(np.float32),
            "w1": rng.randn(2, 3).astype(np.float32),
            "w0_steps": np.arange(4)}
    assert pchaos.maybe_inject_numeric(3, rank=0, incarnation=0) == mode
    want = jchaos.apply_numeric(dict(tree), mode)
    got = pchaos.apply_numeric(dict(tree), mode)
    got_t = pchaos.apply_numeric({k: torch.from_numpy(v.copy())
                                  for k, v in tree.items()}, mode)
    for k in tree:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got_t[k].numpy(), want[k])
    # the input leaf is never written: the fault lands on a copy
    assert np.isfinite(tree["w1"]).all()


def test_heartbeat_monitor_names_the_silent_worker():
    from paddle_tpu_torch.distributed.fleet.utils import (
        HeartbeatMonitor, HeartbeatWorker, KVServer)
    with KVServer(0) as srv:
        ep = f"127.0.0.1:{srv.port}"
        w0 = HeartbeatWorker(ep, 0, interval=None)
        w1 = HeartbeatWorker(ep, 1, interval=None)
        with HeartbeatMonitor(ep, 2, timeout=0.3,
                              startup_timeout=5.0) as mon:
            w0.pulse()
            w1.pulse()
            assert mon.sweep() == []
            dead = []
            t0 = time.time()
            while not dead and time.time() - t0 < 5.0:
                w0.pulse()           # rank 0 keeps stepping, 1 stopped
                time.sleep(0.1)
                dead = mon.sweep()
            assert dead == [1]
            assert mon.alive() == [0]
            mon.revive(1)
            assert mon.dead == []


# -- the numeric drill ----------------------------------------------------------

DRILL = ["--model", "tiny", "--device", "cpu", "--steps", "6",
         "--ckpt-every", "2", "--batch", "4", "--seq", "16", "--sentry",
         "--sentry-probe-every", "1"]


def test_numeric_drill_quarantines_and_resumes_healthy(monkeypatch,
                                                       tmp_path):
    """The sentry drill on 2 ranks under `launch --elastic` (CPU, the
    tiny GPT TrainStep with the sentry armed): a NaN in rank 0's
    gradients at step 3 (PD_CHAOS_MODE nan_grad) is flagged at step 3
    (NumericFault, the grad stream's nonfinite row), the rank commits
    the step stamped unhealthy and exits 13; the doctor's verdict over
    the dumps is NUMERIC for rank 0 (the port's collect_diagnosis and the
    JAX package's on the same dumps agree); the gang respawns with
    PD_ROLLBACK_HEALTHY=1 and rank 0 resumes from the newest
    health-stamped checkpoint at or before step 3 (step 1, whose stamp
    has the two clean steps a probe period of 1 asks for) and goes on
    bit-equal to a control run; the ranks' probe fingerprints agreed."""
    import glob
    import json as _json
    from paddle_tpu_torch.distributed import elastic_worker, launch
    from paddle_tpu_torch.observability import decisions
    for var in ("PD_CHAOS_EVERY", "CUDA_VISIBLE_DEVICES",
                "PD_ROLLBACK_HEALTHY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PD_ELASTIC_DIR", str(tmp_path / "receipts"))
    monkeypatch.setenv("PD_FR_DIR", str(tmp_path / "flight"))
    was = decisions.enabled()
    control = elastic_worker.run(elastic_worker.parse_args(
        DRILL + ["--ckpt-dir", str(tmp_path / "c_ckpt"),
                 "--out-dir", str(tmp_path / "c_out")]))
    monkeypatch.setenv("PD_CHAOS_MODE", "nan_grad")
    monkeypatch.setenv("PD_CHAOS_STEP", "3")
    monkeypatch.setenv("PD_CHAOS_RANK", "0")
    out = tmp_path / "out"
    try:
        with pytest.raises(SystemExit) as ex:
            launch.launch(["--elastic", "--nproc_per_node", "2",
                           "--heartbeat_timeout", "20",
                           "--restart_backoff", "0.05",
                           "--dump_grace", "0.2", elastic_worker.__file__,
                           "--ckpt-dir", str(tmp_path / "ckpt"),
                           "--out-dir", str(out), *DRILL])
    finally:
        decisions.reset()
        decisions.enable(was)
    assert ex.value.code == 0
    (rec,) = [_json.load(open(f)) for f in glob.glob(
        str(tmp_path / "receipts" / "receipt_*.json"))]
    assert rec["verdict"]["kind"] == "numeric"
    assert rec["verdict"]["rank"] == 0
    first = _json.load(open(out / "inc0_slot0.json"))
    second = _json.load(open(out / "inc1_slot0.json"))
    fault = first["fault"]
    assert fault["step"] == 3 and "nonfinite" in fault["reason"]
    assert fault["health"]["healthy"] is False
    assert [a["kind"] for a in fault["anomalies"]] == ["nonfinite"]
    assert second["require_healthy"] is True
    assert second["resume_step"] == 1
    assert second["resume_health"]["healthy"] is True
    # the newest candidate on disk was the unhealthy step-3 commit
    assert second["candidate_steps"][0] == 3
    assert sorted(int(s) for s in second["losses"]) == list(range(2, 6))
    losses = {**first["losses"], **second["losses"]}
    assert losses == control["losses"]
    # the probe steps' fingerprints agreed across the ranks (rank 0's
    # control run computes the same)
    other = _json.load(open(out / "inc0_slot1.json"))
    for s in ("0", "1", "2"):
        assert first["fingerprints"][s] == other["fingerprints"][s] == \
            control["fingerprints"][s]
    assert (out / "fault_slot0.npz").exists()
    # the doctor bridge: the same verdict from the JAX package's merge
    flight = str(tmp_path / "flight")
    got = pel.collect_diagnosis(flight)["verdict"]
    want = jel.collect_diagnosis(flight)["verdict"]
    assert got["kind"] == want["kind"] == "numeric"
    assert got["rank"] == want["rank"] == 0
