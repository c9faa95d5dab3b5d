"""The elastic drill worker: a GPT TrainStep that checkpoints, resumes and
survives chaos (counterpart of tests/elastic_worker.py's sharded mode).

Run it under the elastic launcher:

    python -m paddle_tpu_torch.distributed.launch --elastic \\
        paddle_tpu_torch/distributed/elastic_worker.py \\
        --ckpt-dir DIR --out-dir DIR [--model gpt2|tiny] [--device cuda|cpu]

Each step it writes a progress line, calls ``chaos.maybe_inject`` (the
PD_CHAOS_* plan: kill, stall, corrupt_ckpt), runs one TrainStep call,
pulses its heartbeat, and every ``--ckpt-every`` steps saves the step's
state asynchronously (``checkpoint.save_sharded(async_write=True)``)
with a topology manifest carrying its ``DataShardCursor``. At start it
resumes from the newest intact checkpoint (``load_with_topology``; with
slots evicted from the gang, ``load_at_or_before`` their cut), restoring
the TrainStep in place: the params, AdamW's moments and step count, and
the dropout seed stream, so the steps after a resume draw the masks the
uninterrupted run drew.

Data: batch i of one global synthetic dataset is drawn from numpy seed
SEED + i (ids of length seq + 1; the model reads the first seq tokens
and predicts the last seq), so a cursor that skips or repeats a batch
changes the trajectory. Every rank trains on the whole global batch (the
update an all-reduced data-parallel step makes) and logs its own shard
of example ids.

``--sentry`` arms the numeric-integrity plane (the JAX drill worker's,
tests/elastic_worker.py): the TrainStep carries an
observability.sentry.NumericSentry (per-scope grad/param statistics and
the every-``--sentry-probe-every`` fingerprint inside the captured
step, fatal on a non-finite gradient), every checkpoint's manifest
carries the monitor's health stamp (``save_sharded(health=)``), the
ranks exchange their fingerprints over the fleet KV at each probe and
judge them, and ``PD_ROLLBACK_HEALTHY=1`` (the launcher's NUMERIC
remediation) resumes through ``load_at_or_before(require_healthy=True)``.
Numeric chaos (PD_CHAOS_MODE nan_grad or scale_grad) strikes the
unscaled gradients between the backward and the update, through the
TrainStep's grad_hook (chaos.maybe_inject_numeric, apply_numeric). A
confirmed fault (the sentry's NumericFault, or this rank named by the
fingerprint vote) quarantines the rank: the step's state is committed
stamped unhealthy, a fault capture and the flight recorder's dump are
written, and the process exits 13.

``--model gpt2`` is GPT-2 small (vocab 50304, hidden 768, 12 layers, 12
heads) under O1 bf16; ``tiny`` is a 2-layer GPT in f32. Both train with
dropout 0.1 and AdamW(1e-4, weight decay 0.01). The device defaults to
the card; ``--device cpu`` runs on the CPU.

Output, in ``--out-dir``: ``progress_slot<k>.jsonl`` (one line as each
step starts and as it ends, with wall-clock times) and, rewritten after
every step, ``inc<n>_slot<k>.json`` with incarnation n's facts: the
resume step, restore ms, the per-step losses, each save's blocking and
background write ms and bytes, the warm-up's kernel launches, the
TrainStep's graphs and sentinel events, the goodput report, and
``done`` once it finished the job.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

SEED = 0
DATASET_BATCHES = 1 << 16
MODELS = {
    "gpt2": dict(vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=1024, dropout=0.1),
    "tiny": dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                 max_seq_len=64, dropout=0.1),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser("elastic_worker")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--model", choices=sorted(MODELS), default="gpt2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (sequences a step)")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--amp", choices=("O1", "none"), default=None,
                    help="default: O1 bf16 on the card, f32 on the CPU")
    ap.add_argument("--sentry", action="store_true",
                    help="arm the numeric-integrity sentry")
    ap.add_argument("--sentry-probe-every", type=int, default=2,
                    help="the sentry's fingerprint period (steps)")
    return ap.parse_args(argv)


def batch(i: int, gb: int, seq: int, vocab: int):
    """Batch i of the global dataset: (ids, labels), [gb, seq] each."""
    tok = np.random.RandomState(SEED + i).randint(0, vocab, (gb, seq + 1))
    return tok[:, :-1].astype(np.int64), tok[:, 1:].astype(np.int64)


def build(args):
    """(model, step) on args.device, weights from SEED."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.static import TrainStep
    pt.seed(SEED)
    model = GPTForCausalLM(GPTConfig(**MODELS[args.model]),
                           device=args.device).train()
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                weight_decay=0.01)
    amp = args.amp or ("O1" if args.device.startswith("cuda") else "none")
    sentry = None
    if getattr(args, "sentry", False):
        from paddle_tpu_torch.observability import sentry as sentry_mod
        # the JAX drill's monitor: a warming-up model's streams trend, so
        # the z threshold is wide; a healthy stamp needs a clean run past
        # one probe period
        k = int(args.sentry_probe_every)
        sentry = sentry_mod.NumericSentry(sentry_mod.SentryConfig(
            window=8, min_warmup=4,
            z_threshold=float(os.environ.get("PD_SENTRY_Z", "20")),
            fingerprint_every=k, min_clean_for_healthy=k + 1,
            fatal_nonfinite=True))
    step = TrainStep(model, GPTForCausalLM.lm_loss, opt,
                     amp_level=None if amp == "none" else amp,
                     amp_dtype="bfloat16", sentry=sentry)
    return model, step


def _append(path, doc):
    with open(path, "a") as f:
        f.write(json.dumps(doc) + "\n")
        f.flush()


def run(args, rank=0, world=1, slot=0, incarnation=0, hb=None):
    """Resume, train to args.steps, save; returns this incarnation's
    record (also the body of a launched worker)."""
    import torch
    from paddle_tpu_torch.distributed import chaos
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    from paddle_tpu_torch.observability import goodput
    from paddle_tpu_torch.observability.sentry import NumericFault

    model, step = build(args)
    gb, seq = int(args.batch), int(args.seq)
    vocab = MODELS[args.model]["vocab_size"]
    ckpt = os.path.join(args.ckpt_dir, f"slot{slot}")
    cursor = dckpt.DataShardCursor(dataset_size=gb * DATASET_BATCHES,
                                   global_batch=gb)
    start, resume_step, restore_ms = 0, None, None
    # numeric remediation (launch.py sets it on a NUMERIC verdict):
    # resume only onto a health-stamped candidate
    require_healthy = os.environ.get("PD_ROLLBACK_HEALTHY") == "1"
    t0 = time.perf_counter()
    state, topo = dckpt.load_with_topology(ckpt)
    if topo is not None:
        # consistent cut: an EVICTED slot's last committed step bounds
        # the resume (nobody replays its shard of the torn steps unless
        # the survivors roll back to it); a slot that merely respawns
        # replays its own lost tail
        cut = int(topo["step"])
        for s in os.environ.get("PD_GONE_SLOTS", "").split(","):
            if not s.strip() or int(s) == slot:
                continue
            other = dckpt.load_topology(
                os.path.join(args.ckpt_dir, f"slot{int(s)}"))
            cut = min(cut, int(other["step"])
                      if other and other.get("step") is not None else 0)
        if cut < int(topo["step"]) or require_healthy:
            state, topo = dckpt.load_at_or_before(
                ckpt, cut, require_healthy=require_healthy)
        step.set_state_dict(state["train"])
        cursor = dckpt.DataShardCursor.from_state(topo["data_cursor"])
        resume_step = int(topo["step"])
        start = resume_step + 1
        if args.device.startswith("cuda"):
            torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3

    os.makedirs(args.out_dir, exist_ok=True)
    progress = os.path.join(args.out_dir, f"progress_slot{slot}.jsonl")
    rec = {"incarnation": incarnation, "rank": rank, "world": world,
           "resume_step": resume_step, "restore_ms": restore_ms,
           "candidate_steps": _candidate_steps(ckpt),
           "losses": {}, "saves": [], "warmup_launches": None,
           "require_healthy": require_healthy,
           "resume_health": (topo or {}).get("health"),
           "fingerprints": {}, "done": False}
    out = os.path.join(args.out_dir, f"inc{incarnation}_slot{slot}.json")

    def dump():
        rec.update(graphs=step.programs, captures=step.captures,
                   replays=step.replays,
                   sentinel_events=step.recompile_sentinel.fired,
                   goodput=goodput.report())
        with open(out + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(out + ".tmp", out)

    kv = kv_of(world) if step.sentry is not None else None
    for s in range(start, args.steps):
        _append(progress, {"step": s, "phase": "begin", "t": time.time(),
                           "inc": incarnation})
        chaos.maybe_inject(s, rank=rank, incarnation=incarnation,
                           ckpt_path=ckpt)
        i = cursor.epoch * DATASET_BATCHES + cursor.offset // gb
        x, y = batch(i, gb, seq, vocab)
        ids = cursor.indices(rank, world)
        nmode = chaos.maybe_inject_numeric(s, rank=rank,
                                           incarnation=incarnation)
        if nmode in ("nan_grad", "scale_grad"):
            # numeric chaos between the backward and the update, where a
            # corrupted chip's gradients would surface
            step.grad_hook = lambda g, m=nmode: chaos.apply_numeric(g, m)
        fault = None
        try:
            loss = float(step(torch.from_numpy(x).to(args.device),
                              torch.from_numpy(y).to(args.device)))
        except NumericFault as e:
            fault, loss = e, float("nan")
        step.grad_hook = None
        if fault is not None:
            _quarantine(dckpt, rec, step, ckpt, s, cursor, world, gb,
                        args, slot, rank, str(fault), x, y, dump)
        if step.sentry is not None:
            _probe(step, rec, kv, rank, world, s, args, dckpt, ckpt, cursor,
                   gb, slot, x, y, dump)
        if rec["warmup_launches"] is None:
            # the first call's warm-up (an eager step), as the wrappers
            # counted it; its capture records the same launches again
            rec["warmup_launches"] = dict(step.last_launches)
        rec["losses"][str(s)] = loss
        cursor.advance()
        if (s + 1) % args.ckpt_every == 0 or s == args.steps - 1:
            _save(dckpt, rec, step, ckpt, s, cursor, world, gb)
        _append(progress, {"step": s, "phase": "end", "t": time.time(),
                           "inc": incarnation, "loss": loss,
                           "ids": [int(j) for j in ids]})
        dump()
        if hb is not None:
            hb.pulse()
    dckpt.wait_pending()
    if rec["saves"]:
        rec["saves"][-1]["write_ms"] = dckpt.last_save["write_ms"]
    rec["done"] = True
    dump()
    return rec


def _save(dckpt, rec, step, ckpt, s, cursor, world, gb):
    t0 = time.perf_counter()
    if rec["saves"]:
        # the previous write has ended once this save joined it (the
        # join is part of the save's blocking time, join_ms)
        dckpt.wait_pending()
        rec["saves"][-1]["write_ms"] = dckpt.last_save["write_ms"]
    join_ms = (time.perf_counter() - t0) * 1e3
    mon = step.sentry.monitor if step.sentry is not None else None
    dckpt.save_sharded(
        {"train": step.state_dict()}, ckpt, async_write=True,
        topology=dckpt.topology_manifest(
            step=s, data_cursor=cursor.state_dict(), dp=world,
            global_batch=gb,
            health=mon.health_stamp(step=s) if mon is not None else None))
    rec["saves"].append({"step": s,
                         "call_ms": (time.perf_counter() - t0) * 1e3,
                         "block_ms": dckpt.last_save["block_ms"],
                         "join_ms": join_ms,
                         "bytes": dckpt.last_save["nbytes"],
                         "write_ms": None})


def kv_of(world):
    """The fleet KV client of the launcher's heartbeat endpoint, when
    there are peers to exchange fingerprints with."""
    endpoint = os.environ.get("PADDLE_HEARTBEAT_ENDPOINT")
    if not endpoint or world <= 1:
        return None
    from paddle_tpu_torch.distributed.fleet.utils.http_server import \
        KVClient
    return KVClient(endpoint, timeout=2.0)


def _exchange_fingerprints(kv, rank, world, s, fp, timeout=5.0,
                           poll=0.05):
    """Publish this rank's fingerprint for step s over the fleet KV and
    collect the peers' for the same step (best effort: a dead peer or a
    KV outage gives a partial dict)."""
    if kv is None:
        return {}
    epoch = os.environ.get("PD_GANG_EPOCH", "0")
    try:
        kv.put(f"fp/{epoch}/{s}/{rank}", str(fp))
    except Exception:
        return {}
    peers = {}
    deadline = time.time() + timeout
    for r in range(world):
        while r != rank and time.time() < deadline:
            try:
                v = kv.get(f"fp/{epoch}/{s}/{r}")
            except Exception:
                return peers
            if v is not None:
                peers[r] = int(v)
                break
            time.sleep(poll)
    return peers


def _probe(step, rec, kv, rank, world, s, args, dckpt, ckpt, cursor, gb,
           slot, x, y, dump):
    """At a fresh fingerprint (the in-graph probe's step): record it,
    exchange it with the peers, and quarantine this rank when the vote
    names it."""
    mon = step.sentry.monitor
    if mon.last_fingerprint_step != s:
        return
    fp = mon.last_fingerprint
    rec["fingerprints"][str(s)] = fp
    peers = _exchange_fingerprints(kv, rank, world, s, fp)
    if peers and mon.judge_fingerprints(rank, fp, peers, step=s) == rank:
        _quarantine(dckpt, rec, step, ckpt, s, cursor, world, gb, args,
                    slot, rank, "fingerprint divergence (cross-replica "
                    "minority)", x, y, dump)


def _quarantine(dckpt, rec, step, ckpt, s, cursor, world, gb, args, slot,
                rank, reason, x, y, dump):
    """Self-quarantine on a confirmed numeric fault: the step's state is
    committed stamped unhealthy (the monitor's stamp after the anomaly),
    a fault capture (params, the batch, the observed stats) and the
    flight recorder's dump are written, and the process exits 13 so the
    supervisor reads a NUMERIC verdict."""
    from paddle_tpu_torch.observability import flight_recorder as fr
    from paddle_tpu_torch.observability import sentry as sentry_mod
    mon = step.sentry.monitor
    cursor.advance()
    _save(dckpt, rec, step, ckpt, s, cursor, world, gb)
    dckpt.wait_pending()
    rec["fault"] = {"step": s, "reason": reason,
                    "health": mon.health_stamp(step=s),
                    "anomalies": mon.anomalies[-6:]}
    dump()
    names = step._param_names
    params = {k: p.detach() for k, p in zip(names, step.params)}
    observed = {"reason": reason,
                "param": sentry_mod.host_stats_by_scope(params),
                "anomalies": mon.anomalies[-6:]}
    try:
        sentry_mod.write_fault_capture(
            os.path.join(args.out_dir, f"fault_slot{slot}.npz"), params,
            {"x": x, "y": y}, observed=observed, step=s, rank=rank,
            meta={"model": args.model})
    except OSError:
        pass  # the dump below still carries the verdict's evidence
    fr.record("sentry.fault", step=int(s), rank=int(rank), reason=reason)
    fr.dump(reason="numeric_fault")
    os._exit(13)


def _candidate_steps(ckpt):
    """The topology step of each restore candidate on disk, newest
    first (None where a sidecar is missing)."""
    from paddle_tpu_torch.distributed import checkpoint as dckpt
    out = []
    for c in dckpt._load_candidates(ckpt):
        t = dckpt._candidate_topology(c)
        out.append(None if t is None else t.get("step"))
    return out


def main(argv=None):
    args = parse_args(argv)
    from paddle_tpu_torch.observability import flight_recorder as fr
    rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))
    world = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
    slot = int(os.environ.get("PD_SLOT_ID", rank))
    incarnation = int(os.environ.get("PADDLE_RESTART_COUNT", 0))
    # the black box: the supervisor's SIGTERM dumps events and progress
    # for the in-process doctor merge
    fr.enable(crash_handlers=True)
    hb = None
    endpoint = os.environ.get("PADDLE_HEARTBEAT_ENDPOINT")
    if endpoint:
        from paddle_tpu_torch.distributed.fleet.utils.heartbeat import \
            HeartbeatWorker
        hb = HeartbeatWorker(endpoint, rank, interval=None)  # pulse-only
    run(args, rank, world, slot, incarnation, hb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
