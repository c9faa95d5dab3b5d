"""Launcher CLI (counterpart of paddle_tpu/distributed/launch.py).

Usage: python -m paddle_tpu_torch.distributed.launch [--nproc_per_node N]
       [--master ip:port] [--elastic] script [args...]

Each worker is a process of `script` with torch.distributed's
environment set (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK)
beside the PADDLE_* variables the workers read (PADDLE_TRAINER_ID,
PADDLE_TRAINERS_NUM, PADDLE_LOCAL_RANK, PADDLE_RESTART_COUNT, ...). A
worker whose local rank has a card sees that card alone
(CUDA_VISIBLE_DEVICES); one without a card is not pinned. The launcher
starts no process group: a worker that needs one calls
torch.distributed.init_process_group itself (env:// reads the
variables above).

--elastic supervises the workers: the launcher runs a fleet KV, workers
beat hb/<rank> (HeartbeatWorker.pulse per step), a HeartbeatMonitor
sweeps for stalls, and a dead, hung or crashed worker triggers a
restart; workers resume from their checkpoints
(distributed/checkpoint.py). Every decision (respawn, evict + shrink,
grow, abort, the backoff) comes from distributed/elastic.SupervisorPolicy,
fed with the supervisor's own detection plus the tpu_doctor verdict
merged in-process from the flight-recorder dumps the SIGTERM'd workers
leave behind; each episode emits a remediation receipt
(elastic.emit_receipt). Policy `gang` (default) restarts every rank
together, `rank` only the failed one; --elastic_shrink evicts a
verdict-named rank and runs the survivors at the smaller world size,
--grow_after T grows back once the slot has been clear for T seconds.
"""
from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import tempfile
import time


def parse_args(argv):
    import argparse
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes on this host (one per card)")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int,
                   default=int(os.environ.get("PADDLE_NODE_RANK", 0)))
    p.add_argument("--master", type=str,
                   default=os.environ.get("PADDLE_MASTER", ""),
                   help="host:port of rank 0 (MASTER_ADDR/MASTER_PORT); "
                        "default 127.0.0.1 and a free port")
    p.add_argument("--ips", type=str, default="",
                   help="comma list of host ips (informational)")
    p.add_argument("--log_dir", type=str, default=None)
    p.add_argument("--elastic", action="store_true",
                   help="supervise workers: heartbeat + crash detection, "
                        "restart on failure (workers resume from "
                        "auto-checkpoint)")
    p.add_argument("--elastic_policy", choices=("gang", "rank"),
                   default="gang")
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--heartbeat_endpoint", type=str, default="",
                   help="fleet KV for heartbeats; empty = launcher "
                        "starts its own")
    p.add_argument("--heartbeat_timeout", type=float, default=10.0)
    p.add_argument("--heartbeat_startup_timeout", type=float,
                   default=120.0)
    p.add_argument("--restart_backoff", type=float, default=0.5,
                   help="base seconds of exponential backoff between "
                        "respawns (doubles per consecutive failure)")
    p.add_argument("--restart_backoff_max", type=float, default=30.0)
    p.add_argument("--restart_window", type=float, default=60.0,
                   help="sliding window for --restart_budget")
    p.add_argument("--restart_budget", type=int, default=0,
                   help="max respawns per --restart_window (0 = only "
                        "the lifetime --max_restarts budget applies)")
    p.add_argument("--elastic_shrink", action="store_true",
                   help="evict a verdict-named bad rank and run the "
                        "survivors at the smaller world size (workers "
                        "re-shard via the checkpoint topology manifest)")
    p.add_argument("--min_world", type=int, default=1,
                   help="never shrink below this many ranks")
    p.add_argument("--grow_after", type=float, default=0.0,
                   help="seconds after an eviction to grow back to "
                        "full size (0 = stay shrunk)")
    p.add_argument("--dump_grace", type=float, default=0.75,
                   help="seconds to wait for SIGTERM'd workers to dump "
                        "their flight recorders before running the "
                        "doctor")
    p.add_argument("script", type=str)
    p.add_argument("script_args", nargs="...")
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cards() -> list:
    """The card ids this launcher may hand out, in local-rank order:
    the parent's CUDA_VISIBLE_DEVICES list, else 0..n-1 for the n cards
    torch sees (none without CUDA)."""
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = ([v.strip() for v in vis.split(",") if v.strip()]
           if vis is not None else [str(i) for i in range(n)])
    return ids[:n]


def _worker_env(args, local_rank, world, extra=None):
    rank = args.node_rank * args.nproc_per_node + local_rank
    env = dict(os.environ)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "MASTER_ADDR": args.master_addr,
        "MASTER_PORT": str(args.master_port),
        "LOCAL_RANK": str(local_rank),
    })
    if extra:
        env.update(extra)
    # torch.distributed's names follow the (possibly renumbered) gang
    env["RANK"] = env["PADDLE_TRAINER_ID"]
    env["WORLD_SIZE"] = env["PADDLE_TRAINERS_NUM"]
    if local_rank < len(args.cards):
        env["CUDA_VISIBLE_DEVICES"] = args.cards[local_rank]
    return env


def _spawn(args, local_rank, world, extra_env=None):
    rank = args.node_rank * args.nproc_per_node + local_rank
    cmd = [sys.executable, args.script] + list(args.script_args)
    stdout = None
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
        stdout = open(os.path.join(args.log_dir,
                                   f"worker.{rank}.log"), "a")
    try:
        proc = subprocess.Popen(
            cmd, env=_worker_env(args, local_rank, world, extra_env),
            stdout=stdout, stderr=subprocess.STDOUT if stdout else None)
    finally:
        # the child holds its own copy of the fd; closing the parent's
        # stops the elastic loop from leaking one per respawn
        if stdout is not None:
            stdout.close()
    return proc


def _terminate(proc, grace=5.0):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _elastic_supervise(args, world) -> int:
    from .fleet.utils import KVServer
    from .fleet.utils.heartbeat import HeartbeatMonitor
    from . import elastic
    from ..observability import decisions as _ledger

    if args.nnodes > 1:
        # a launcher-private KV can't see remote ranks, and a gang
        # bounce of only the LOCAL procs would leave remote peers in
        # the old collective incarnation: wedged, not recovered
        raise SystemExit(
            "--elastic is single-node: multi-node recovery needs one "
            "supervisor per node coordinating over a shared KV")
    server = None
    endpoint = args.heartbeat_endpoint
    if not endpoint:
        server = KVServer(0).start()
        endpoint = f"127.0.0.1:{server.port}"
    # workers dump their flight recorders here (SIGTERM chains into the
    # black-box dump when they arm crash handlers); the doctor merge
    # and the remediation receipts read/write the same directory
    dump_dir = os.environ.get("PD_FR_DIR")
    if not dump_dir:
        dump_dir = (os.path.join(args.log_dir, "flight") if args.log_dir
                    else tempfile.mkdtemp(prefix="pd_elastic_fr_"))
    receipts = os.environ.get("PD_ELASTIC_DIR", dump_dir)
    extra = {"PADDLE_HEARTBEAT_ENDPOINT": endpoint,
             "PD_FR_DIR": dump_dir}

    policy = elastic.SupervisorPolicy(
        world=world, max_restarts=args.max_restarts,
        policy=args.elastic_policy,
        backoff_base=args.restart_backoff,
        backoff_max=args.restart_backoff_max,
        restart_window_s=args.restart_window,
        restart_budget=args.restart_budget,
        allow_shrink=args.elastic_shrink, min_world=args.min_world,
        grow_after_s=args.grow_after)

    incarnation = {lr: 0 for lr in range(args.nproc_per_node)}
    completed: set = set()
    prev_goodput = None
    # doctor-merge window: dumps older than the last bounce belong to
    # an already-remediated episode (each incarnation has a fresh pid,
    # so old dump files accumulate) — merging them again could pin a
    # stale verdict on a now-healthy rank. Pre-detection evidence for
    # the CURRENT episode (a watchdog stall dump minutes before the
    # monitor trips) is still inside the window: it postdates the
    # bounce that spawned this incarnation.
    since_ts = {"v": time.time()}

    # slots evicted from the gang: their checkpoints hold the last
    # step they COMMITTED, and the survivors must roll back to that
    # consistent cut so the gone rank's shard of any torn step is
    # replayed, not skipped (a slot that merely respawns replays its
    # own lost tail itself — no rollback needed for it)
    gone_slots = {"v": ""}
    # slots growing BACK into the gang: their checkpoints are STALE
    # (frozen at the eviction cut while the survivors kept training),
    # so the regrown incarnation must ADOPT the survivors' current
    # params + cursor instead of resuming its own tail — workers run
    # the planner-spec'd resync phase (broadcast for replicated
    # params, all-gather for fsdp-sharded ones, over the fleet KV)
    # when their slot is named here
    regrown_slots = {"v": ""}
    # bumped on every gang bounce and shared by the whole gang: workers
    # namespace their KV step-gate keys with it, so stale gate values
    # from a previous incarnation can never satisfy (and so void) the
    # lock-step barrier after a rollback
    gang_epoch = {"v": 0}
    # set for the bounce remediating a NUMERIC verdict: silent data
    # corruption may have trained into checkpoints committed after the
    # fault, so the resume must land on a health-STAMPED candidate
    # (checkpoint.load_at_or_before(require_healthy=True)), never
    # merely the newest
    rollback_healthy = {"v": ""}

    def spawn_slot(lr):
        # PADDLE_TRAINER_ID is the CONTIGUOUS rank in the current
        # (possibly shrunk) gang; PD_SLOT_ID is the stable slot
        # identity workers key their checkpoints on across re-numbering
        ranks = sorted(policy.active)
        return _spawn(args, lr, len(ranks),
                      dict(extra,
                           PADDLE_RESTART_COUNT=str(incarnation[lr]),
                           PADDLE_TRAINER_ID=str(ranks.index(lr)),
                           PADDLE_TRAINERS_NUM=str(len(ranks)),
                           PD_SLOT_ID=str(lr),
                           PD_GANG_EPOCH=str(gang_epoch["v"]),
                           PD_GONE_SLOTS=gone_slots["v"],
                           PD_REGROWN_SLOTS=regrown_slots["v"],
                           PD_ROLLBACK_HEALTHY=rollback_healthy["v"]))

    def bounce_gang(monitor):
        # collective jobs can't re-admit one rank: bounce the gang;
        # completed ranks re-run too and fast-forward via their epoch
        # guard (test_preemption resume-skip)
        for p in procs.values():
            _terminate(p)
        procs.clear()
        completed.clear()
        gang_epoch["v"] += 1
        since_ts["v"] = time.time()  # close this episode's dump window
        # incarnation boundary for the ledger: a decision made after
        # this instant on evidence observed before it is acted-on-
        # stale-evidence (tpu_doctor flags those)
        _ledger.note_bounce()
        for lr in policy.active:
            incarnation[lr] += 1
            procs[lr] = spawn_slot(lr)
        # fresh monitor: the gang's world size / rank numbering may
        # have changed, and every restarted rank gets the startup
        # grace period again. revive() resets each KV slot to the
        # never-beat sentinel — otherwise the monitor reads the STALE
        # pre-bounce counter as a first beat and puts the restarted
        # (still importing) worker on the short stall clock
        monitor.close()
        fresh = HeartbeatMonitor(
            endpoint, len(policy.active),
            timeout=args.heartbeat_timeout,
            startup_timeout=args.heartbeat_startup_timeout)
        for r in range(len(policy.active)):
            fresh.revive(r)
        return fresh

    procs = {}
    monitor = None
    try:
        procs = {lr: spawn_slot(lr) for lr in policy.active}
        monitor = HeartbeatMonitor(
            endpoint, len(policy.active), timeout=args.heartbeat_timeout,
            startup_timeout=args.heartbeat_startup_timeout)
        while True:
            time.sleep(0.25)
            policy.note_progress()
            # steady-state post-signals for the outcome joiner: a
            # healthy poll is the evidence a remediation/grow worked
            # (failures back to zero); pending records join once their
            # settle window expires
            _ledger.observe("supervisor.remediate", {"failures": 0})
            _ledger.observe("supervisor.grow", {"failures": 0})
            _ledger.join_outcomes()
            failed = []
            for lr, p in list(procs.items()):
                if lr in completed or lr not in policy.active:
                    continue
                rc = p.poll()
                if rc is None:
                    continue
                if rc == 0:
                    completed.add(lr)
                else:
                    failed.append((lr, f"exit rc={rc}"))
            # hung-but-alive workers: heartbeat counter stopped moving
            ranks_now = sorted(policy.active)
            for mrank in monitor.sweep():
                if mrank >= len(ranks_now):
                    continue
                lr = ranks_now[mrank]
                if lr in procs and lr not in completed and \
                        not any(f[0] == lr for f in failed):
                    failed.append((lr, "heartbeat stall"))
            if len(completed) >= len(policy.active):
                monitor.close()
                return 0
            if not failed:
                grow = policy.maybe_grow()
                if grow is not None:
                    print(f"[elastic] growing back rank(s) "
                          f"{grow.ranks}: {grow.reason}",
                          file=sys.stderr)
                    wb = len(policy.active) - len(grow.ranks)
                    # only THIS bounce runs the resync phase: once the
                    # regrown slot has adopted the survivors' state,
                    # later bounces resume it like any other slot
                    regrown_slots["v"] = ",".join(str(r)
                                                  for r in grow.ranks)
                    monitor = bounce_gang(monitor)
                    regrown_slots["v"] = ""
                    elastic.emit_receipt(
                        episode=grow.episode, verdict=grow.verdict,
                        action="grow", ranks=grow.ranks,
                        world_before=wb,
                        world_after=len(policy.active),
                        reason=grow.reason,
                        extras={"dump_dir": dump_dir},
                        decision_id=grow.decision_id,
                        out_dir=receipts)
                continue

            # ---- failure episode -----------------------------------------
            world_before = len(policy.active)
            # terminate first: SIGTERM chains into the workers'
            # flight-recorder dumps — the doctor's evidence
            gang_down = args.elastic_policy == "gang" or \
                args.elastic_shrink
            if gang_down:
                for p in procs.values():
                    _terminate(p)
            else:
                for lr, _why in failed:
                    _terminate(procs[lr])
            time.sleep(args.dump_grace)
            bundle = elastic.collect_diagnosis(dump_dir,
                                               since_ts=since_ts["v"])
            # dumps record CONTIGUOUS gang ranks; the policy tracks
            # stable slots — translate before any slot comparison
            verdict = elastic.translate_verdict_rank(
                bundle["verdict"], ranks_now)
            decision = policy.decide(
                failed, verdict, evidence_ts=bundle.get("evidence_ts"))
            if decision.action == "abort":
                print(f"[elastic] rank(s) {[f[0] for f in failed]} "
                      f"failed and {decision.reason} "
                      "exhausted; aborting job", file=sys.stderr)
                for p in procs.values():
                    _terminate(p)
                elastic.emit_receipt(
                    episode=decision.episode, verdict=decision.verdict,
                    action="abort", ranks=[f[0] for f in failed],
                    world_before=world_before,
                    world_after=world_before,
                    resume_step=bundle["resume_step"],
                    goodput=bundle["goodput"],
                    reason=decision.reason,
                    extras={"dump_dir": dump_dir},
                    decision_id=decision.decision_id,
                    out_dir=receipts)
                monitor.close()
                return 1
            for lr, why in failed:
                print(f"[elastic] rank {lr} down ({why}); restart "
                      f"{policy.restarts + 1}/{args.max_restarts} "
                      f"(policy={args.elastic_policy})", file=sys.stderr)
            if decision.verdict.get("kind") not in (None, "none"):
                print(f"[elastic] verdict: {decision.verdict['kind']} "
                      f"rank {decision.verdict.get('rank')} "
                      f"(source={decision.verdict.get('source')}) -> "
                      f"{decision.action}", file=sys.stderr)
            if decision.delay_s > 0:
                print(f"[elastic] backoff {decision.delay_s:.2f}s "
                      "before respawn", file=sys.stderr)
                time.sleep(decision.delay_s)
            policy.record_respawn()
            # NUMERIC remediation: whatever the action (quarantine-
            # evict or gang respawn), the resuming workers must walk
            # to a health-stamped checkpoint — corruption may have
            # been committed before the sentry confirmed it
            if decision.verdict.get("kind") == "numeric":
                rollback_healthy["v"] = "1"
                print("[elastic] numeric verdict: resume requires a "
                      "health-stamped checkpoint", file=sys.stderr)
            if decision.action == "evict_shrink":
                print(f"[elastic] evicting rank(s) {decision.ranks}; "
                      f"gang shrinks {world_before} -> "
                      f"{len(policy.active)}", file=sys.stderr)
                for r in decision.ranks:
                    p = procs.pop(r, None)
                    if p is not None:
                        _terminate(p)
                # only THIS bounce rolls back to the evicted slots'
                # cut; once the survivors have replayed the torn
                # steps, later bounces must not drag the gang back
                gone_slots["v"] = ",".join(str(r)
                                           for r in decision.ranks)
                monitor = bounce_gang(monitor)
                gone_slots["v"] = ""
                rollback_healthy["v"] = ""
            elif decision.action == "respawn_rank" and not gang_down:
                since_ts["v"] = time.time()
                for lr in decision.ranks:
                    _terminate(procs[lr])
                    incarnation[lr] += 1
                    monitor.revive(lr)
                    procs[lr] = spawn_slot(lr)
                # the health requirement applies to THIS episode's
                # respawns only — a later unrelated crash must not
                # inherit it (stamp-less fleets would spuriously walk
                # the uncertified-fallback path forever)
                rollback_healthy["v"] = ""
            else:  # respawn_gang (or the gang was already taken down)
                monitor = bounce_gang(monitor)
                rollback_healthy["v"] = ""
            gp = bundle.get("goodput")
            delta = None
            if gp and prev_goodput:
                delta = round(
                    gp.get("productive_fraction", 0.0)
                    - prev_goodput.get("productive_fraction", 0.0), 6)
            if gp:
                prev_goodput = gp
            receipt = elastic.emit_receipt(
                episode=decision.episode, verdict=decision.verdict,
                action=decision.action,
                ranks=(decision.ranks
                       if decision.action == "evict_shrink"
                       else [f[0] for f in failed]),
                world_before=world_before,
                world_after=len(policy.active),
                resume_step=bundle["resume_step"], goodput=gp,
                goodput_delta=delta, delay_s=decision.delay_s,
                reason=decision.reason,
                # the receipt an operator reads at 3am should name
                # where the black boxes that drove the verdict live
                extras={"dump_dir": dump_dir},
                decision_id=decision.decision_id,
                out_dir=receipts)
            if receipt.get("path"):
                print(f"[elastic] remediation receipt: "
                      f"{receipt['path']}", file=sys.stderr)
    finally:
        # close the ledger's books whatever path exits: pending
        # decisions join against the last post-decision observation
        # (or stamp `unjoined` honestly), and the decisions dump lands
        # next to the remediation receipts for the drills / doctor
        try:
            _ledger.join_outcomes(force=True)
            _ledger.dump(reason="supervisor_exit", out_dir=receipts)
        except Exception:
            pass
        # a supervisor crash (KeyboardInterrupt, EMFILE, ...) must not
        # orphan training processes holding the cards
        for p in procs.values():
            try:
                _terminate(p)
            except Exception:
                pass
        if monitor is not None:
            monitor.close()
        if server is not None:
            server.stop()


def launch(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    world = args.nnodes * args.nproc_per_node
    host, _, port = args.master.partition(":")
    args.master_addr = host or "127.0.0.1"
    args.master_port = int(port) if port else _free_port()
    args.cards = _cards()
    if args.elastic:
        sys.exit(_elastic_supervise(args, world))
    procs = [_spawn(args, lr, world) for lr in range(args.nproc_per_node)]
    rc = 0
    for p in procs:
        p.wait()
        rc = rc or p.returncode
    sys.exit(rc)


if __name__ == "__main__":
    launch()
