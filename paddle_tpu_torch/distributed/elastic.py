"""Self-healing elastic fleet: the verdict -> remediation state machine
(counterpart of paddle_tpu/distributed/elastic.py; the same decisions,
snapshots, ledger records, receipts and ``elastic.*`` counters).

It contains no subprocess or socket code: ``SupervisorPolicy`` is a pure
state machine the launcher (``distributed/launch.py --elastic``) and the
serving fleet (``serving/fleet.py``) drive, so every evict / shrink /
backoff / abort / scale decision is testable against canned verdicts
with no processes at all.

``SupervisorPolicy``
    One failure episode at a time (process exits, heartbeat stalls, plus
    the doctor's merged verdict) -> a ``Decision``: respawn the gang or
    one rank, evict the named rank and shrink, grow back, or abort; with
    exponential backoff, a lifetime ``max_restarts`` budget and a
    restarts-per-window budget. ``decide_scale`` is the serving mode's
    SLO-aware autoscale on the same state.

``effective_verdict``
    The doctor's verdict when it names a rank; else synthesized from the
    supervisor's own detection (``crash`` from a process exit,
    ``heartbeat_stall`` from the monitor).

``emit_receipt``
    One JSON remediation receipt per episode, written to
    ``$PD_ELASTIC_DIR`` (default: the flight-recorder dump dir), plus
    always-on ``elastic.*`` counters in the port's metrics registry.

``collect_diagnosis``
    Merges the flight-recorder dumps in-process with the repo's
    ``tools/tpu_doctor.py`` (standard library only), loaded by file path;
    only its ``load_dumps``, ``diagnose`` and ``verdict`` are called.
"""
from __future__ import annotations

import glob
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..observability import decisions as _dec
from ..observability import metrics as _obs

__all__ = ["Decision", "SupervisorPolicy", "effective_verdict",
           "translate_verdict_rank", "collect_diagnosis",
           "emit_receipt", "receipts_dir", "NONE_VERDICT"]

NONE_VERDICT = {"kind": "none", "rank": None, "source": "doctor",
                "evidence": {}}

# verdict kinds that name a culpable rank precisely enough to evict it;
# a straggler or recompile storm is a cost, not a fault — respawn, don't
# shrink. "numeric" is the sentry's SDC verdict: the named chip's
# arithmetic diverged (fingerprint minority vote / first stat spike) —
# quarantine it, and roll the survivors back to a HEALTH-STAMPED
# checkpoint (launch.py sets PD_ROLLBACK_HEALTHY for the bounce)
_EVICTABLE = ("divergence", "hang", "heartbeat_stall", "crash",
              "numeric")

# autoscale actions the SERVING mode adds (decide_scale): the fleet
# spawns the named slot on scale_up and DRAINS it on scale_down
SCALE_ACTIONS = ("scale_up", "scale_down")


@dataclass
class Decision:
    """One remediation decision. action ∈ respawn_gang / respawn_rank /
    evict_shrink / grow / abort."""
    action: str
    ranks: List[int] = field(default_factory=list)  # evicted/grown slots
    delay_s: float = 0.0       # backoff to sleep BEFORE respawning
    reason: str = ""
    episode: int = 0
    verdict: dict = field(default_factory=lambda: dict(NONE_VERDICT))
    decision_id: Optional[str] = None   # ledger id (decisions.record);
                                        # call sites stamp it into their
                                        # remediation/scale receipts

    def as_dict(self) -> dict:
        """The replay-comparison surface: everything the decision IS,
        minus the ledger id (assigned at record time, not decided)."""
        return {"action": self.action, "ranks": list(self.ranks),
                "delay_s": self.delay_s, "reason": self.reason,
                "episode": self.episode, "verdict": dict(self.verdict)}


def translate_verdict_rank(verdict: Optional[dict],
                           ranks_now: Sequence[int]) -> Optional[dict]:
    """Map a doctor verdict's rank — the CONTIGUOUS gang rank the
    dump's PADDLE_TRAINER_ID recorded — onto the stable slot id the
    policy tracks. After a shrink renumbers the gang (slots [0,2,3]
    run as ranks 0,1,2), comparing the raw rank against slot ids would
    evict a healthy slot or silently skip the eviction. Out-of-range
    ranks (a stale dump from a larger gang) drop the rank rather than
    guess."""
    if not verdict or verdict.get("rank") is None:
        return verdict
    v = dict(verdict)
    r = int(v["rank"])
    if 0 <= r < len(ranks_now):
        v["rank"] = int(ranks_now[r])
    else:
        v["rank"] = None
    return v


def effective_verdict(failures: Sequence[Tuple[int, str]],
                      doctor_verdict: Optional[dict]) -> dict:
    """The doctor's verdict when it names a rank; else the supervisor's
    own detection, so every receipt records what drove the action.

    One guard: a doctor HANG naming a rank the supervisor's own
    detection did NOT flag is suspect — when one rank wedges, every
    peer blocked on its collective also stops stepping and dumps a
    stall, so the hang set usually contains casualties. The
    supervisor's failure evidence (that rank stopped pulsing / its
    process died) is the more precise signal then. A divergence
    verdict is proof and always wins."""
    if doctor_verdict and doctor_verdict.get("rank") is not None:
        v = dict(doctor_verdict)
        failed = {int(r) for r, _ in failures}
        if v.get("kind") != "hang" or not failed or v["rank"] in failed:
            return v
    if failures:
        rank, why = failures[0]
        kind = "heartbeat_stall" if "heartbeat" in why else "crash"
        return {"kind": kind, "rank": int(rank), "source": "supervisor",
                "evidence": {"why": why,
                             "all_failed": [int(r) for r, _ in failures]}}
    return dict(NONE_VERDICT)


class SupervisorPolicy:
    """Pure decision core of the elastic supervisor.

    State: the set of active ranks (shrink removes, grow restores),
    respawn timestamps (for the per-window budget), and the
    consecutive-failure count (for exponential backoff — reset by
    ``note_progress`` once the job has run cleanly for ``heal_after_s``).
    """

    def __init__(self, world: int, max_restarts: int = 3,
                 policy: str = "gang",
                 backoff_base: float = 0.5, backoff_factor: float = 2.0,
                 backoff_max: float = 30.0,
                 restart_window_s: float = 60.0,
                 restart_budget: int = 0,
                 allow_shrink: bool = False, min_world: int = 1,
                 grow_after_s: float = 0.0,
                 heal_after_s: float = 20.0,
                 scale_cooldown_s: float = 5.0,
                 initial_world: Optional[int] = None):
        if policy not in ("gang", "rank"):
            raise ValueError(f"unknown elastic policy {policy!r}")
        self.world = int(world)
        if initial_world is not None and not (
                1 <= int(initial_world) <= self.world):
            raise ValueError(
                f"initial_world={initial_world} outside [1, {world}]")
        self.max_restarts = int(max_restarts)
        self.policy = policy
        self.backoff_base = float(backoff_base)
        self.backoff_factor = float(backoff_factor)
        self.backoff_max = float(backoff_max)
        self.restart_window_s = float(restart_window_s)
        self.restart_budget = int(restart_budget)  # 0 = disabled
        self.allow_shrink = bool(allow_shrink)
        self.min_world = max(1, int(min_world))
        self.grow_after_s = float(grow_after_s)
        self.heal_after_s = float(heal_after_s)
        self.scale_cooldown_s = float(scale_cooldown_s)
        # serving fleets start below max capacity: world is the slot
        # budget, initial_world the live set (scale_up fills spares)
        self.active: List[int] = list(range(
            self.world if initial_world is None else int(initial_world)))
        self.evicted: Dict[int, float] = {}     # rank -> eviction ts
        self.episode = 0
        self.restarts = 0                        # lifetime respawn count
        self._respawn_ts: List[float] = []       # for the window budget
        self._consecutive = 0
        self._last_respawn: Optional[float] = None
        self._last_scale: Optional[float] = None
        self._grow_deferred = False   # dedup: one grow_deferred record
                                      # per exhausted-budget episode

    # -- replayable state ----------------------------------------------------
    def state_snapshot(self) -> dict:
        """JSON-safe snapshot of config + mutable state. Every ledger
        record carries the snapshot the decision READ, so a replay can
        rebuild this exact policy
        (``from_snapshot``) and re-run the decision bit-identically."""
        return {
            "world": self.world, "max_restarts": self.max_restarts,
            "policy": self.policy,
            "backoff_base": self.backoff_base,
            "backoff_factor": self.backoff_factor,
            "backoff_max": self.backoff_max,
            "restart_window_s": self.restart_window_s,
            "restart_budget": self.restart_budget,
            "allow_shrink": self.allow_shrink,
            "min_world": self.min_world,
            "grow_after_s": self.grow_after_s,
            "heal_after_s": self.heal_after_s,
            "scale_cooldown_s": self.scale_cooldown_s,
            "active": list(self.active),
            "evicted": {str(r): float(ts)
                        for r, ts in self.evicted.items()},
            "episode": self.episode, "restarts": self.restarts,
            "respawn_ts": list(self._respawn_ts),
            "consecutive": self._consecutive,
            "last_respawn": self._last_respawn,
            "last_scale": self._last_scale,
        }

    @classmethod
    def from_snapshot(cls, snap: dict) -> "SupervisorPolicy":
        """Rebuild a policy from ``state_snapshot()`` output (JSON
        round-trip safe — evicted keys come back as strings)."""
        p = cls(world=snap["world"],
                max_restarts=snap["max_restarts"],
                policy=snap["policy"],
                backoff_base=snap["backoff_base"],
                backoff_factor=snap["backoff_factor"],
                backoff_max=snap["backoff_max"],
                restart_window_s=snap["restart_window_s"],
                restart_budget=snap["restart_budget"],
                allow_shrink=snap["allow_shrink"],
                min_world=snap["min_world"],
                grow_after_s=snap["grow_after_s"],
                heal_after_s=snap["heal_after_s"],
                scale_cooldown_s=snap["scale_cooldown_s"])
        p.active = [int(r) for r in snap["active"]]
        p.evicted = {int(r): float(ts)
                     for r, ts in snap["evicted"].items()}
        p.episode = int(snap["episode"])
        p.restarts = int(snap["restarts"])
        p._respawn_ts = [float(t) for t in snap["respawn_ts"]]
        p._consecutive = int(snap["consecutive"])
        p._last_respawn = snap["last_respawn"]
        p._last_scale = snap["last_scale"]
        return p

    # -- observations --------------------------------------------------------
    def note_progress(self, now: Optional[float] = None):
        """Call on any healthy tick: once the job has run cleanly for
        heal_after_s since the last respawn, the backoff ladder resets
        (a one-off preemption must not leave 30 s penalties behind)."""
        now = time.monotonic() if now is None else now
        if (self._consecutive and self._last_respawn is not None
                and now - self._last_respawn >= self.heal_after_s):
            self._consecutive = 0

    def record_respawn(self, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        self.restarts += 1
        self._respawn_ts.append(now)
        self._last_respawn = now

    def record_scale_spawn(self, now: Optional[float] = None):
        """A scale_up/grow spawn spends the restarts-per-WINDOW budget
        (spawning is the expensive action the window bounds) but NOT
        the lifetime ``max_restarts`` crash-loop budget — routine
        demand scaling must never erode the abort threshold a real
        crash loop is measured against."""
        now = time.monotonic() if now is None else now
        self._respawn_ts.append(now)

    # -- decisions -----------------------------------------------------------
    def backoff_delay(self) -> float:
        return min(self.backoff_max,
                   self.backoff_base
                   * self.backoff_factor ** self._consecutive)

    def decide(self, failures: Sequence[Tuple[int, str]],
               doctor_verdict: Optional[dict] = None,
               now: Optional[float] = None,
               evidence_ts: Optional[float] = None) -> Decision:
        """One failure episode → one Decision. `failures` are
        (global_rank, why) pairs from the supervisor's own detection.
        Replay-determinism contract: every branch reads only (self,
        arguments) — no wall clock (`now` is injected), no ambient
        state. `evidence_ts` is ledger metadata (when the doctor
        evidence was observed; tpu_doctor's staleness check), never a
        decision input."""
        now = time.monotonic() if now is None else now
        state = self.state_snapshot()
        inputs = {"failures": [[int(r), str(w)] for r, w in failures],
                  "doctor_verdict": (dict(doctor_verdict)
                                     if doctor_verdict else None),
                  "now": now}
        self.episode += 1

        def _led(d: Decision) -> Decision:
            d.decision_id = _dec.record(
                "supervisor.remediate", d.action,
                rule=d.reason or d.action,
                evidence={"inputs": inputs, "state": state,
                          "decision": d.as_dict()},
                signals={"failures": len(failures),
                         "episode": self.episode},
                settle_s=self.heal_after_s, clock=now,
                evidence_ts=evidence_ts)
            return d

        v = effective_verdict(failures, doctor_verdict)
        # crash-loop guards run BEFORE any respawn so a worker dying at
        # import cannot burn the budget in seconds
        if self.restarts + 1 > self.max_restarts:
            return _led(Decision(
                "abort", reason=f"max_restarts={self.max_restarts}",
                episode=self.episode, verdict=v))
        if self.restart_budget:
            recent = [t for t in self._respawn_ts
                      if now - t <= self.restart_window_s]
            if len(recent) + 1 > self.restart_budget:
                return _led(Decision(
                    "abort",
                    reason=(f"restart budget {self.restart_budget}/"
                            f"{self.restart_window_s:g}s"),
                    episode=self.episode, verdict=v))
        delay = self.backoff_delay()
        self._consecutive += 1
        # eviction: verdict names a rank precisely, shrink is allowed,
        # and the survivors still form a viable gang
        if (self.allow_shrink and v.get("kind") in _EVICTABLE
                and v.get("rank") in self.active
                and len(self.active) - 1 >= self.min_world):
            rank = int(v["rank"])
            self.active.remove(rank)
            self.evicted[rank] = now
            return _led(Decision(
                "evict_shrink", ranks=[rank], delay_s=delay,
                reason=f"evict rank {rank} ({v['kind']})",
                episode=self.episode, verdict=v))
        if self.policy == "rank":
            ranks = sorted({int(r) for r, _ in failures}) or list(
                self.active)
            return _led(Decision(
                "respawn_rank", ranks=ranks, delay_s=delay,
                reason="rank restart", episode=self.episode,
                verdict=v))
        return _led(Decision(
            "respawn_gang", ranks=list(self.active),
            delay_s=delay, reason="gang restart",
            episode=self.episode, verdict=v))

    def maybe_grow(self, now: Optional[float] = None) -> Optional[Decision]:
        """Grow back to full size once a replacement slot is available
        — here, once the evicted rank's cooldown (`grow_after_s`)
        passed, modeling a preempted host coming back. Disabled when
        grow_after_s == 0.

        A grow is a SPAWN: it spends the same restarts-per-window
        budget a scale_up does (``record_scale_spawn`` per restored
        slot — the window bounds spawning, whatever triggered it) and
        DEFERS while the budget is exhausted instead of bypassing the
        flap guard, leaving a ``grow_deferred`` ledger record so the
        non-action is auditable too."""
        if not self.grow_after_s or not self.evicted:
            return None
        now = time.monotonic() if now is None else now
        ready = sorted(r for r, ts in self.evicted.items()
                       if now - ts >= self.grow_after_s)
        if not ready:
            return None
        state = self.state_snapshot()
        inputs = {"now": now, "ready": list(ready)}
        if self.restart_budget:
            recent = [t for t in self._respawn_ts
                      if now - t <= self.restart_window_s]
            if len(recent) + len(ready) > self.restart_budget:
                if not self._grow_deferred:
                    self._grow_deferred = True
                    _dec.record(
                        "supervisor.grow", "grow_deferred",
                        rule=(f"restart budget {self.restart_budget}/"
                              f"{self.restart_window_s:g}s exhausted: "
                              f"grow of {ready} deferred"),
                        evidence={"inputs": inputs, "state": state,
                                  "decision": None},
                        clock=now)
                return None
        self._grow_deferred = False
        for r in ready:
            del self.evicted[r]
            self.active.append(r)
            self.record_scale_spawn(now=now)
        self.active.sort()
        self.episode += 1
        d = Decision("grow", ranks=ready, delay_s=0.0,
                     reason=f"replacement for rank(s) {ready}",
                     episode=self.episode,
                     verdict=dict(NONE_VERDICT))
        d.decision_id = _dec.record(
            "supervisor.grow", "grow", rule=d.reason,
            evidence={"inputs": inputs, "state": state,
                      "decision": d.as_dict()},
            signals={"failures": 0, "episode": self.episode},
            settle_s=self.heal_after_s, clock=now)
        return d

    # -- serving mode --------------------------------------------------------
    def decide_scale(self, slo, queued: int, p99_ttft_ms: float,
                     now: Optional[float] = None,
                     burn_alert: bool = False) -> Optional[Decision]:
        """SERVING-mode autoscale: one scale decision from the
        ``serving.*`` signals the fleet publishes every tick. Pure —
        the fleet applies the Decision (spawn the slot on ``scale_up``,
        drain it on ``scale_down``).

        `slo` is duck-typed (serving.fleet.ServingSLO): `p99_ttft_ms`
        (0 disables the latency trigger), `queue_high` / `queue_low`
        (queued-requests-per-live-replica watermarks). Guards:

        - one shared cooldown (`scale_cooldown_s`) for BOTH directions
          — an up/down flap is two scale actions inside one cooldown;
        - scale_up spends the same restarts-per-window budget as a
          respawn (spawning an engine is the expensive action the
          budget exists to bound) and only takes a slot that is neither
          live nor cooling down from an eviction;
        - scale_down needs observed traffic (p99 >= 0, i.e. at least
          one finished request) so a fleet warming up before its first
          arrivals is not shrunk to the floor, and never drops below
          `min_world`. The highest live slot drains (stable low slots
          keep their warm engines).
        - ``burn_alert`` is the FORWARD-LOOKING trigger: the fleet's
          multi-window SLO error-budget burn (reqtrace.BurnMeter) says
          the budget is being spent faster than it accrues, even when
          the instantaneous p99 has recovered. It scales up like a
          breach and vetoes scale_down (never shrink while the budget
          burns).
        """
        now = time.monotonic() if now is None else now
        if (self._last_scale is not None
                and now - self._last_scale < self.scale_cooldown_s):
            return None
        live = len(self.active)
        slo_p99 = float(getattr(slo, "p99_ttft_ms", 0.0) or 0.0)
        breach = slo_p99 > 0 and p99_ttft_ms > slo_p99
        hot = queued > int(slo.queue_high) * max(1, live)
        burn = bool(burn_alert)
        if (hot or breach or burn) and live < self.world:
            if self.restart_budget:
                recent = [t for t in self._respawn_ts
                          if now - t <= self.restart_window_s]
                if len(recent) + 1 > self.restart_budget:
                    return None  # flapping: let the window slide first
            spare = sorted(set(range(self.world)) - set(self.active)
                           - set(self.evicted))
            if not spare:
                return None  # every spare slot is an eviction cooldown
            state = self.state_snapshot()
            slot = spare[0]
            self.active.append(slot)
            self.active.sort()
            self._last_scale = now
            self.episode += 1
            reason = (f"p99 TTFT {p99_ttft_ms:.0f}ms > SLO "
                      f"{slo_p99:.0f}ms" if breach else
                      f"queued {queued} > {slo.queue_high}/replica "
                      f"x {live}" if hot else
                      "SLO error budget fast-burning across every "
                      "window (burn rate > 1)")
            kind = ("slo_breach" if breach
                    else "overload" if hot else "budget_burn")
            return self._ledger_scale(Decision(
                "scale_up", ranks=[slot], episode=self.episode,
                reason=reason,
                verdict={"kind": kind,
                         "rank": None, "source": "serving_policy",
                         "evidence": {"queued": int(queued),
                                      "p99_ttft_ms": float(p99_ttft_ms),
                                      "burn_alert": burn,
                                      "live": live}}),
                state, slo, queued, p99_ttft_ms, burn, now)
        if (not hot and not breach and not burn and p99_ttft_ms >= 0
                and live > self.min_world
                and queued <= int(slo.queue_low) * live):
            state = self.state_snapshot()
            slot = max(self.active)
            self.active.remove(slot)
            self._last_scale = now
            self.episode += 1
            return self._ledger_scale(Decision(
                "scale_down", ranks=[slot], episode=self.episode,
                reason=(f"idle: queued {queued} <= {slo.queue_low}"
                        f"/replica x {live}, p99 {p99_ttft_ms:.0f}ms"),
                verdict={"kind": "underload", "rank": None,
                         "source": "serving_policy",
                         "evidence": {"queued": int(queued),
                                      "p99_ttft_ms": float(p99_ttft_ms),
                                      "live": live}}),
                state, slo, queued, p99_ttft_ms, burn, now)
        return None

    def _ledger_scale(self, d: Decision, state: dict, slo,
                      queued: int, p99_ttft_ms: float, burn: bool,
                      now: float) -> Decision:
        """Record one serving-scale decision: evidence = the exact
        signals + pre-mutation state decide_scale read; the joiner
        re-reads queue/p99 from the fleet's per-tick ``observe`` once
        the (shared-cooldown-sized) settle window passes — the next
        legal scale instant is exactly when "did it help" is asked."""
        d.decision_id = _dec.record(
            "supervisor.scale", d.action, rule=d.reason,
            evidence={
                "inputs": {
                    "slo": {"p99_ttft_ms": float(
                                getattr(slo, "p99_ttft_ms", 0.0) or 0.0),
                            "queue_high": int(slo.queue_high),
                            "queue_low": int(
                                getattr(slo, "queue_low", 0))},
                    "queued": int(queued),
                    "p99_ttft_ms": float(p99_ttft_ms),
                    "burn_alert": bool(burn), "now": now},
                "state": state, "decision": d.as_dict()},
            signals={"queued": int(queued),
                     "p99_ttft_ms": float(p99_ttft_ms)},
            settle_s=self.scale_cooldown_s, clock=now)
        return d


# -- doctor bridge ------------------------------------------------------------

_doctor = None


def _import_doctor():
    """The checkout's tools/tpu_doctor.py, loaded once by file path under
    a private name and kept out of sys.modules. It imports only the
    standard library at load; of it the supervisor calls load_dumps,
    diagnose and verdict (its perf-ledger report reads the JAX package
    and is never called from here). None outside a checkout."""
    global _doctor
    if _doctor is None:
        import importlib.util
        p = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            "tools", "tpu_doctor.py")
        if not os.path.exists(p):
            return None
        spec = importlib.util.spec_from_file_location("_pt_tpu_doctor", p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _doctor = mod
    return _doctor


def collect_diagnosis(dump_dir: str,
                      since_ts: Optional[float] = None) -> dict:
    """Run the tpu_doctor merge in-process over `dump_dir` and bundle
    what the supervisor needs: the diagnosis, the verdict, the deepest
    resume step seen, and the fleet-mean goodput. `since_ts` filters
    out black boxes from earlier runs sharing the directory."""
    doctor = _import_doctor()
    paths = sorted(glob.glob(os.path.join(dump_dir, "flight_*.json")))
    if since_ts is not None:
        paths = [p for p in paths
                 if os.path.getmtime(p) >= since_ts]
    out = {"dumps": len(paths), "diagnosis": None,
           "verdict": dict(NONE_VERDICT), "resume_step": None,
           "goodput": None, "evidence_ts": None}
    if not paths or doctor is None:
        return out
    try:
        dumps = doctor.load_dumps(paths)
        diag = doctor.diagnose(dumps)
    except Exception:
        return out  # an unreadable dump must not kill the supervisor
    out["diagnosis"] = diag
    out["verdict"] = doctor.verdict(diag)
    # when the verdict's evidence was OBSERVED (newest contributing
    # dump): the ledger's staleness check compares this against the
    # incarnation boundary — acting on a previous incarnation's dumps
    # is a failure class of its own
    ts_seen = [d.get("ts") for d in dumps
               if isinstance(d.get("ts"), (int, float))]
    if ts_seen:
        out["evidence_ts"] = float(max(ts_seen))
    steps = [(d.get("progress") or {}).get("steps") for d in dumps]
    steps = [s for s in steps if s is not None]  # step 0 is a step
    if steps:
        out["resume_step"] = int(max(steps))
    out["goodput"] = diag.get("goodput")
    return out


# -- remediation receipts -----------------------------------------------------

def receipts_dir() -> str:
    return os.environ.get(
        "PD_ELASTIC_DIR",
        os.environ.get("PD_FR_DIR", "/tmp/pd_flight"))


def emit_receipt(episode: int, verdict: dict, action: str,
                 ranks: Sequence[int], world_before: int,
                 world_after: int, resume_step: Optional[int] = None,
                 goodput: Optional[dict] = None,
                 goodput_delta: Optional[float] = None,
                 delay_s: float = 0.0, reason: str = "",
                 extras: Optional[dict] = None,
                 decision_id: Optional[str] = None,
                 out_dir: Optional[str] = None) -> dict:
    """Write one structured remediation receipt and mirror it into the
    always-on ``elastic.*`` registry series (counters stay visible with
    the hot-path gate down — remediation at 3am must leave evidence)."""
    doc = {
        "version": 1,
        "ts": time.time(),
        "episode": int(episode),
        "verdict": dict(verdict or NONE_VERDICT),
        "action": action,
        "ranks": [int(r) for r in ranks],
        "world_before": int(world_before),
        "world_after": int(world_after),
        "resume_step": resume_step,
        "goodput": goodput,
        "goodput_delta": goodput_delta,
        "backoff_s": round(float(delay_s), 3),
        "reason": reason,
    }
    if decision_id:
        # the receipt ↔ ledger join key: every autonomous action's
        # receipt names the DecisionRecord that drove it (the chaos
        # drills assert this and a joined outcome)
        doc["decision_id"] = decision_id
    if extras:
        # free-form evidence the action's subsystem wants on the paper
        # trail (dump dir, requeue counts, per-class TTFT, ...)
        doc["extras"] = dict(extras)
    d = out_dir or receipts_dir()
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"receipt_ep{int(episode)}_pid{os.getpid()}.json")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        doc["path"] = path
    except OSError:
        doc["path"] = None  # receipt still returned to the caller
    _obs.counter("elastic.episodes_total", _always=True).add(1)
    _obs.counter("elastic.actions_total", _always=True,
                 action=action).add(1)
    if action == "evict_shrink":
        _obs.counter("elastic.evictions_total", _always=True).add(
            len(doc["ranks"]))
    if action in ("respawn_gang", "respawn_rank", "evict_shrink",
                  "grow"):
        _obs.counter("elastic.restarts_total", _always=True).add(1)
    _obs.counter("elastic.backoff_seconds_total",
                 _always=True).add(float(delay_s))
    _obs.gauge("elastic.world_size", _always=True).set(int(world_after))
    _obs.gauge("elastic.last_episode", _always=True).set(int(episode))
    return doc
