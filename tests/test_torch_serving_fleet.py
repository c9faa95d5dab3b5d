"""The port's self-healing serving fleet (paddle_tpu_torch/serving/fleet.py)
against the JAX package's ServingFleet, on the CPU.

A tiny f32 GPT (vocab 97, hidden 32, 2 layers, paddle.seed(3)) is
carried into the port by name (load_jax_params). Each scenario drives
both fleets with the same requests and the same faults: a chaos kill of
replica 1 at tick 2, a covert stall, a hot swap of the same and of other
weights (the latter from a checkpoint the port's save_sharded wrote), a
chaos corrupt_swap, overload shedding, and autoscale up and down. The
finished streams (each request's tokens and finish reason),
requeued_total, shed_total, the swap counts and the episodes' (action,
ranks, verdict kind) must be equal; every stream must also equal an
uninterrupted engine's on the serving weights (requeued ones included:
the exact-requeue contract, bit for bit in f32). Then the port alone:
a killed replica's engine is released, the rollup skips and flags a dead
replica, the request trace labels spans with the replica and the fleet
tick, and a requeue-incapable ladder is refused.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import chaos as jchaos
from paddle_tpu.models import GPTConfig as JaxConfig
from paddle_tpu.models import GPTForCausalLM as JaxGPT
from paddle_tpu import serving as jserving
from paddle_tpu_torch import serving as pserving
from paddle_tpu_torch.distributed import chaos as pchaos
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM, load_jax_params

SMALL = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
             max_seq_len=64, dropout=0.0)
F32 = dict(max_slots=4, max_admit=2, block_size=4, n_blocks=48,
           prefill_buckets=(24,), max_total_tokens=24, decode_chunk=2,
           dtype=None)


def _pair(seed):
    paddle.seed(seed)
    jm = JaxGPT(JaxConfig(use_flash_attention=False, **SMALL))
    jm.eval()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig(**SMALL), device="cpu").eval()
    return jm, load_jax_params(tm, state)


@pytest.fixture(scope="module")
def models():
    return {"a": _pair(3), "b": _pair(31)}


@pytest.fixture
def chaos_env(monkeypatch):
    for var in ("PD_CHAOS_MODE", "PD_CHAOS_STEP", "PD_CHAOS_RANK",
                "PD_CHAOS_EVERY"):
        monkeypatch.delenv(var, raising=False)
    jchaos.reset_plan_cache()
    pchaos.reset_plan_cache()
    yield monkeypatch
    jchaos.reset_plan_cache()
    pchaos.reset_plan_cache()


def _prompts(seed, specs):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, (n,)).astype(np.int32) for n, _ in specs]


STAGGER = [(7, 8), (3, 6), (11, 5), (2, 7)]


def _run(pkg, model, other, scenario, tmp):
    """Drive one fleet of package `pkg` (the JAX or the port serving
    module) through `scenario`; returns (observables, fleet, requests,
    prompts, budgets, the weights the streams were served on)."""
    slo, fc, specs = pkg.ServingSLO(), {}, STAGGER
    serving_model = model
    if scenario == "shed":
        slo, fc = pkg.ServingSLO(shed_queue_depth=2), dict(replicas=1,
                                                           max_replicas=1)
    elif scenario == "scale_up":
        # a TTFT SLO no run breaches: the JAX fleet's first requests
        # wait on compiles, so a real one would decide on the clock
        slo = pkg.ServingSLO(queue_high=2, queue_low=0, p99_ttft_ms=1e9)
        fc = dict(replicas=1, max_replicas=2, autoscale=True,
                  scale_cooldown_s=0.0)
        specs = [(4, 4)] * 8
    elif scenario == "scale_down":
        slo = pkg.ServingSLO(queue_high=100, queue_low=1, p99_ttft_ms=1e9)
        fc = dict(autoscale=True, scale_cooldown_s=0.0)
        specs = [(4, 4)] * 3
    elif scenario == "stall":
        fc = dict(stall_ticks=3)
    fleet = pkg.ServingFleet(
        model, pkg.ServingConfig(**F32), slo,
        pkg.FleetConfig(**dict(dict(replicas=2, min_replicas=1,
                                    max_replicas=2, autoscale=False,
                                    backoff_base=0.0,
                                    receipts_dir=str(tmp)), **fc)))
    prompts = _prompts(1, specs)
    budgets = [n for _, n in specs]
    if scenario == "swap_other":
        # other weights, flipped one replica a tick before any traffic
        # (swap_same flips under load, where the weights are equal)
        if pkg is pserving:
            from paddle_tpu_torch.distributed import checkpoint as ck
            from paddle_tpu_torch.models.generation import _gpt_params
            path = str(tmp / "weights")
            ck.save_sharded({"params": _gpt_params(other)}, path)
            assert fleet.swap_weights(checkpoint_path=path) is True
        else:
            assert fleet.swap_weights(other) is True
        while fleet._standby is not None:
            fleet.step()
        serving_model = other
    if scenario == "shed":
        frs = [fleet.submit(prompts[i], budgets[i], cls="batch")
               for i in range(4)]
        frs += [fleet.submit(prompts[i], budgets[i]) for i in range(4)]
        prompts, budgets = prompts * 2, budgets * 2
    else:
        frs = [fleet.submit(p, n) for p, n in zip(prompts, budgets)]
    if scenario == "stall":
        fleet.step()
        fleet.stall_replica(next(fr.replica for fr in frs
                                 if fr.replica is not None), 600.0)
    elif scenario == "swap_same":
        fleet.step()
        assert fleet.swap_weights(model) is True
    done = fleet.run_until_drained()
    while fleet._standby is not None:
        fleet.step()
    if scenario == "scale_down":
        for _ in range(3):
            fleet.step()
    obs = dict(
        streams=[(list(map(int, fr.emitted)), fr.finish_reason, fr.shed)
                 for fr in frs],
        finished=len(done), requeued=fleet.requeued_total,
        shed=fleet.shed_total, swaps=fleet.swaps_total,
        swaps_aborted=fleet.swaps_aborted,
        episodes=[(e["action"], list(e["ranks"]), e["verdict"]["kind"])
                  for e in fleet.episodes],
        live=fleet.live_replicas(),
        recompiles=fleet.recompile_events())
    return obs, fleet, frs, prompts, budgets, serving_model


CHAOS = {"kill": ("kill", "2", "1"), "corrupt_swap": ("corrupt_swap",
                                                      "1", "0")}


@pytest.mark.parametrize("scenario", ["kill", "stall", "swap_same",
                                      "swap_other", "corrupt_swap", "shed",
                                      "scale_up", "scale_down"])
def test_fleet_matches_jax_fleet(models, chaos_env, tmp_path, scenario):
    if scenario in CHAOS:
        mode, step, rank = CHAOS[scenario]
        chaos_env.setenv("PD_CHAOS_MODE", mode)
        chaos_env.setenv("PD_CHAOS_STEP", step)
        chaos_env.setenv("PD_CHAOS_RANK", rank)
    (jm, tm), (jo, to) = models["a"], models["b"]
    want, jfl, *_ = _run(jserving, jm, jo, scenario, tmp_path / "jax")
    got, fleet, frs, prompts, budgets, served = _run(
        pserving, tm, to, scenario, tmp_path / "port")
    if scenario == "corrupt_swap":
        # the chaos plan armed the sabotage at tick 1; the swap now
        # aborts in both fleets and the old weights keep serving
        for fl in (jfl, fleet):
            assert fl.swap_weights(fl._model) is False
        got["swaps_aborted"] = fleet.swaps_aborted
        want["swaps_aborted"] = jfl.swaps_aborted
        got["episodes"] = [(e["action"], e["verdict"]["kind"])
                           for e in fleet.episodes]
        want["episodes"] = [(e["action"], e["verdict"]["kind"])
                            for e in jfl.episodes]
        assert got["swaps_aborted"] == 1
        assert fleet._standby is None
    assert got == want
    # every stream equals an uninterrupted engine's on the serving
    # weights (a requeued one included); shed ones carry no tokens
    ref = pserving.ServingEngine(served, pserving.ServingConfig(**F32))
    live = [(p, n) for (p, n), fr in zip(zip(prompts, budgets), frs)
            if not fr.shed]
    outs = iter(ref.generate_tokens([p for p, _ in live],
                                    [n for _, n in live]))
    for fr in frs:
        if fr.shed:
            assert fr.emitted == [] and fr.finish_reason == "shed"
        else:
            assert list(fr.emitted) == [int(t) for t in next(outs)]
    expect = {"kill": dict(requeued=1), "stall": dict(requeued=2),
              "shed": dict(shed=2), "swap_same": dict(swaps=1),
              "swap_other": dict(swaps=1)}.get(scenario, {})
    for k, v in expect.items():
        assert got[k] >= v, (k, got[k])
    if scenario == "scale_up":
        assert ("scale_up", [1], "overload") in got["episodes"]
    if scenario == "scale_down":
        assert got["episodes"][-1][0] == "scale_down"
        assert got["live"] == [0]
        assert all(fr.evictions == 0 for fr in frs)
    assert got["recompiles"] == 0


def test_killed_engine_is_released_and_rollup_flags_it(models, tmp_path):
    _, tm = models["a"]
    fleet = pserving.ServingFleet(
        tm, pserving.ServingConfig(**F32), pserving.ServingSLO(),
        pserving.FleetConfig(replicas=2, max_replicas=2, autoscale=False,
                             receipts_dir=str(tmp_path)))
    eng = fleet._replicas[1].engine
    assert eng.trace_replica == 1
    fleet.kill_replica(1)
    assert eng.params is None and eng.cache.pools is None
    assert len(eng.programs) == 0
    m = fleet.aggregate(timeout_s=1.0)
    assert m["fleet.sources_reporting"]["value"] == 1
    assert m["fleet.sources_skipped"]["value"] == 1
    fleet.step()                     # remediation: evict_shrink
    assert fleet.episodes[-1]["action"] == "evict_shrink"
    assert fleet.live_replicas() == [0]
    assert fleet.executable_count() == fleet.expected_executables()


def test_request_trace_labels_replica_and_fleet_tick(models, tmp_path):
    from paddle_tpu_torch.observability import reqtrace as rt
    _, tm = models["a"]
    rt.enable()
    rt.reset()
    try:
        fleet = pserving.ServingFleet(
            tm, pserving.ServingConfig(**F32), pserving.ServingSLO(),
            pserving.FleetConfig(replicas=2, max_replicas=2,
                                 autoscale=False, backoff_base=0.0,
                                 receipts_dir=str(tmp_path)))
        frs = [fleet.submit(p, n) for p, n in
               zip(_prompts(5, STAGGER), [n for _, n in STAGGER])]
        for _ in range(3):
            fleet.step()
        victim = next(fr for fr in frs if len(fr.emitted) >= 2
                      and fr.replica is not None)
        slot = victim.replica
        fleet.kill_replica(slot)
        fleet.run_until_drained()
        tls = rt.timelines()
        spans = tls[victim.rid]["spans"]
        decode = [s for s in spans if s["comp"] == "decode"]
        assert decode and all(s.get("replica") is not None
                              for s in decode)
        assert {s["tick"] for s in decode} <= set(range(1, fleet._tick + 1))
        rq = [s for s in spans if s["comp"] == "requeue"]
        assert len(rq) == 1 and rq[0]["replica_from"] == slot
        tail = rt.explain_tail(p=0.0)
        assert tail["requests"] == 4
    finally:
        rt.disable()
        rt.reset()


def test_requeue_needs_a_ladder_covering_every_prefix(models):
    _, tm = models["a"]
    with pytest.raises(ValueError, match="resumable prefix"):
        pserving.ServingFleet(
            tm, pserving.ServingConfig(**dict(F32, prefill_buckets=(8, 16))),
            pserving.ServingSLO(),
            pserving.FleetConfig(replicas=1, max_replicas=1))
