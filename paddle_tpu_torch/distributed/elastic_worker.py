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
    step = TrainStep(model, GPTForCausalLM.lm_loss, opt,
                     amp_level=None if amp == "none" else amp,
                     amp_dtype="bfloat16")
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

    model, step = build(args)
    gb, seq = int(args.batch), int(args.seq)
    vocab = MODELS[args.model]["vocab_size"]
    ckpt = os.path.join(args.ckpt_dir, f"slot{slot}")
    cursor = dckpt.DataShardCursor(dataset_size=gb * DATASET_BATCHES,
                                   global_batch=gb)
    start, resume_step, restore_ms = 0, None, None
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
        if cut < int(topo["step"]):
            state, topo = dckpt.load_at_or_before(ckpt, cut)
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
           "done": False}
    out = os.path.join(args.out_dir, f"inc{incarnation}_slot{slot}.json")

    def dump():
        rec.update(graphs=step.programs, captures=step.captures,
                   replays=step.replays,
                   sentinel_events=step.recompile_sentinel.fired,
                   goodput=goodput.report())
        with open(out + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(out + ".tmp", out)

    for s in range(start, args.steps):
        _append(progress, {"step": s, "phase": "begin", "t": time.time(),
                           "inc": incarnation})
        chaos.maybe_inject(s, rank=rank, incarnation=incarnation,
                           ckpt_path=ckpt)
        i = cursor.epoch * DATASET_BATCHES + cursor.offset // gb
        x, y = batch(i, gb, seq, vocab)
        ids = cursor.indices(rank, world)
        loss = float(step(torch.from_numpy(x).to(args.device),
                          torch.from_numpy(y).to(args.device)))
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
    dckpt.save_sharded(
        {"train": step.state_dict()}, ckpt, async_write=True,
        topology=dckpt.topology_manifest(
            step=s, data_cursor=cursor.state_dict(), dp=world,
            global_batch=gb))
    rec["saves"].append({"step": s,
                         "call_ms": (time.perf_counter() - t0) * 1e3,
                         "block_ms": dckpt.last_save["block_ms"],
                         "join_ms": join_ms,
                         "bytes": dckpt.last_save["nbytes"],
                         "write_ms": None})


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
