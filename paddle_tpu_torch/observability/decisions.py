"""Control-plane decision ledger: every autonomous action ships its
evidence, its measured outcome, and a deterministic replay.

The forensics planes (flight recorder, reqtrace, timeseries, the cost
model's audit loop) all watch the *data plane*. But the system also
ACTS on that telemetry: the elastic supervisor evicts and regrows
slots, ``decide_scale`` spawns and drains serving replicas, the fleet
sheds and hot-swaps, ``load_at_or_before(require_healthy=True)`` walks
certified rollbacks, and ``MeshPlan.auto`` picks layouts. This module
is the black box for those actions — GC3's discipline (verify control
logic as a checkable artifact, not on a burning pod) plus TVM's
measure-don't-assume loop applied to operational decisions: every
prediction ("scaling up will recover p99") is later joined against
what actually happened.

One ``DecisionRecord`` per autonomous action::

    {decision_id, ts, actor, action, rule, evidence,
     outcome: improved|neutral|worse|unjoined, joined_ts,
     outcome_evidence}

``evidence`` is the ACTUAL inputs snapshot the pure decision function
read — the verdict dict, the queue/p99/burn signals, the candidate
costs of a layout pick, the health stamps of a rollback walk — which
is what makes ``tools/incident_replay.py`` possible: feed the evidence
back through the decision logic and assert bit-identical actions.
The replay-determinism contract this imposes on actors: NO wall-clock
reads inside decision functions (they take ``now``), no RNG, no
ambient state outside the recorded snapshot.

The **outcome joiner** re-reads the same signals after a configurable
settle window and stamps each record:

  improved / worse   the comparable signals moved (beyond a relative
                     tolerance band) in / against the metric's good
                     direction — ``judge_signals`` below
  neutral            signals re-read, nothing moved beyond the band
  unjoined           the settle window expired with NO post-signal
                     (never conflated with neutral: "we don't know"
                     is a different fact from "nothing changed")

Post-signals arrive three ways: a push (``observe(actor, signals)``
from the actor's steady-state tick — the serving fleet publishes its
queue/p99 every ``_publish``), a pull (``probe=`` callable recorded
with the decision — the layout pick reads the planner's
``planner.prediction_error`` gauge), or immediately
(``post_signals=`` — a rollback knows its outcome the moment the
restore lands). A SECOND decision by the same actor inside the settle
window force-joins the first against the second's pre-action signals
— the first action's outcome must never be judged on state the second
action already changed.

Conventions are the flight recorder's: no torch imports (the ledger
must dump while the card is wedged), one module bool gate (``_enabled``; a
disabled ``record()`` is a function call plus a bool read, <1 µs —
but unlike the data-plane rings this gate defaults ON: decisions are
cold control-plane events, and a supervisor that healed a pod at 3am
must leave the paper trail), lock-light appends (GIL-atomic deque),
and atomic per-rank JSON dumps — ``decisions_<reason>_rank<r>_pid<p>
.json`` under the same ``$PD_FR_DIR`` directory contract tpu_doctor
globs.

Always-on registry series (ride every existing exporter, the pulse
server, and the fleet rollup): ``decision.total{actor,action}``
counters and ``decision.outcome{verdict=}`` gauges.
"""
from __future__ import annotations

import itertools
import json
import os
import socket
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import metrics as _obs
from .flight_recorder import _rank, _world, default_dir

__all__ = [
    "DecisionRecord", "OUTCOMES", "enable", "disable", "enabled",
    "reset", "record", "observe", "join_outcomes", "judge_signals",
    "records", "get", "pending_count", "outcome_counts", "dump",
    "default_dump_path", "note_bounce", "incarnation_ts", "glob_dumps",
    "LOWER_BETTER", "HIGHER_BETTER",
]

_enabled = True       # ON by default: decisions are cold control-plane
                      # events; the gate exists for test isolation and
                      # for replay (incident_replay re-runs the actors
                      # with the ledger off so a replay never records)

_CAPACITY = 4096
OUTCOMES = ("improved", "neutral", "worse", "unjoined")

# ``judge_signals`` direction metadata: which way is "better" for the
# comparable signals actors snapshot. Anything not listed is evidence,
# not a judged signal (e.g. `live`: replica count growing is the
# mechanical effect of scale_up, not proof it helped).
LOWER_BETTER = frozenset((
    "p99_ttft_ms", "queued", "queue_depth", "failures", "episode",
    "restarts", "consecutive_failures", "prediction_error",
    "step_time_s", "shed",
))
HIGHER_BETTER = frozenset((
    "productive_fraction", "goodput", "tokens_per_s", "healthy",
    "restored", "verified", "completed",
))
_REL_BAND = 0.05      # |relative move| <= band -> no vote (neutral-ish)

# signals where a negative value is a "no data yet" sentinel, not a
# measurement (the fleet's rolling p99 is -1.0 before the first
# completion) — never judge against a sentinel
_NEGATIVE_IS_MISSING = frozenset(("p99_ttft_ms",))


@dataclass
class DecisionRecord:
    """One autonomous action and, eventually, its measured outcome."""
    decision_id: str
    ts: float                  # wall clock (timeline merge / staleness)
    actor: str
    action: str
    rule: str                  # the guard/watermark that fired, human form
    evidence: dict             # the decision function's actual inputs
    outcome: str = "unjoined"
    joined_ts: Optional[float] = None
    outcome_evidence: Optional[dict] = None
    evidence_ts: Optional[float] = None   # when the evidence was OBSERVED
                                          # (tpu_doctor's staleness check)

    def as_dict(self) -> dict:
        return {
            "decision_id": self.decision_id, "ts": self.ts,
            "actor": self.actor, "action": self.action,
            "rule": self.rule, "evidence": self.evidence,
            "outcome": self.outcome, "joined_ts": self.joined_ts,
            "outcome_evidence": self.outcome_evidence,
            "evidence_ts": self.evidence_ts,
        }


class _Pending:
    __slots__ = ("rec", "clock", "deadline", "signals", "probe", "judge")

    def __init__(self, rec, clock, deadline, signals, probe, judge):
        self.rec = rec
        self.clock = clock
        self.deadline = deadline
        self.signals = signals
        self.probe = probe
        self.judge = judge


_records: deque = deque(maxlen=_CAPACITY)
_pending: List[_Pending] = []
_observations: Dict[str, Tuple[float, dict]] = {}
_counter = itertools.count()
_outcome_counts: Dict[str, int] = {}
_born_ts = time.time()
_incarnation_ts = _born_ts     # bumped by note_bounce(): decisions made
                               # AFTER a bounce on evidence observed
                               # BEFORE it are acted-on-stale-evidence


def enable(on: bool = True) -> bool:
    global _enabled
    _enabled = bool(on)
    return _enabled


def disable() -> bool:
    return enable(False)


def enabled() -> bool:
    return _enabled


def reset():
    """Drop all ledger state (test isolation). Re-arms the gate and
    resets the incarnation clock to now."""
    global _enabled, _incarnation_ts
    _records.clear()
    _pending.clear()
    _observations.clear()
    _outcome_counts.clear()
    _enabled = True
    _incarnation_ts = time.time()


def note_bounce(ts: Optional[float] = None):
    """Mark a gang bounce / incarnation boundary. Evidence observed
    before this instant is STALE for any decision made after it —
    tpu_doctor flags those (the failure class of acting on a
    previous incarnation's dumps)."""
    global _incarnation_ts
    _incarnation_ts = time.time() if ts is None else float(ts)


def incarnation_ts() -> float:
    return _incarnation_ts


# -- the judge ---------------------------------------------------------------

def judge_signals(pre: dict, post: dict) -> str:
    """Generic outcome verdict from the signals the actor snapshotted
    at decision time vs the same keys re-read after the settle window.
    Each comparable key votes by its direction metadata; moves inside
    the ±5% relative band don't vote. Net votes > 0 → improved,
    < 0 → worse, 0 → neutral. Keys with no direction metadata, missing
    on either side, non-numeric, or sitting at a no-data sentinel are
    skipped — an outcome is judged only on real, shared measurements."""
    score = 0
    for k in set(pre) & set(post):
        if k in LOWER_BETTER:
            sign = -1.0
        elif k in HIGHER_BETTER:
            sign = 1.0
        else:
            continue
        a, b = pre[k], post[k]
        if isinstance(a, bool):
            a = int(a)
        if isinstance(b, bool):
            b = int(b)
        if not isinstance(a, (int, float)) or not isinstance(
                b, (int, float)):
            continue
        if k in _NEGATIVE_IS_MISSING and (a < 0 or b < 0):
            continue
        base = max(abs(a), abs(b))
        if base == 0:
            continue
        delta = (b - a) / base
        if abs(delta) <= _REL_BAND:
            continue
        score += 1 if sign * delta > 0 else -1
    if score > 0:
        return "improved"
    if score < 0:
        return "worse"
    return "neutral"


def _publish_outcome(outcome: str):
    _outcome_counts[outcome] = _outcome_counts.get(outcome, 0) + 1
    # publish ALL taxonomy members every time so the exposition is
    # stable (byte-parity between the file export and a pulse scrape
    # must not depend on which verdicts happened to occur first)
    for v in OUTCOMES:
        _obs.gauge("decision.outcome", _always=True,
                   verdict=v).set(_outcome_counts.get(v, 0))


def _join(entry: _Pending, post: Optional[dict] = None):
    """Close one pending record: judge against `post` when provided,
    else the newest observation strictly after the decision, else the
    recorded probe; no post-signal at all stamps `unjoined` — NEVER
    neutral."""
    try:
        _pending.remove(entry)
    except ValueError:
        return
    rec = entry.rec
    if post is None:
        obs = _observations.get(rec.actor)
        if obs is not None and obs[0] > entry.clock:
            post = obs[1]
    if post is None and entry.probe is not None:
        try:
            post = entry.probe()
        except Exception:
            post = None
    if post is None:
        rec.outcome = "unjoined"
        rec.outcome_evidence = {"pre": entry.signals, "post": None}
    else:
        post = dict(post)
        judge = entry.judge or judge_signals
        try:
            verdict = judge(entry.signals, post)
        except Exception:
            verdict = "unjoined"
        rec.outcome = verdict if verdict in OUTCOMES else "unjoined"
        rec.outcome_evidence = {"pre": entry.signals, "post": post}
    rec.joined_ts = time.time()
    _publish_outcome(rec.outcome)


# -- the ledger --------------------------------------------------------------

def record(actor: str, action: str, rule: str, evidence: dict, *,
           signals: Optional[dict] = None, settle_s: float = 0.0,
           probe: Optional[Callable[[], Optional[dict]]] = None,
           judge: Optional[Callable[[dict, dict], str]] = None,
           post_signals: Optional[dict] = None,
           clock: Optional[float] = None,
           evidence_ts: Optional[float] = None) -> Optional[str]:
    """Append one DecisionRecord; returns its decision_id (None when
    the ledger is disabled — callers stamp it into their receipts
    as-is).

    `signals` is the comparable sub-snapshot of `evidence` the joiner
    will re-read (queue/p99, goodput, failure counts). `clock` is the
    decision function's OWN clock value (`now` — time.monotonic
    family); the settle deadline lives on that clock so injected-clock
    tests stay deterministic, while `ts` is always wall time for
    timeline merges. `post_signals` joins immediately (the actor knew
    the outcome at decision time, e.g. a rollback that just restored).
    """
    if not _enabled:
        return None
    clk = time.monotonic() if clock is None else float(clock)
    # a second decision by the same actor inside a pending settle
    # window closes the first AGAINST THIS DECISION'S PRE-ACTION
    # SIGNALS — never against state the new action will change
    for p in [p for p in _pending if p.rec.actor == actor]:
        _join(p, post=(dict(signals) if signals else None))
    rec = DecisionRecord(
        decision_id=f"d{_rank()}-{os.getpid()}-{next(_counter)}",
        ts=time.time(), actor=str(actor), action=str(action),
        rule=str(rule), evidence=evidence, evidence_ts=evidence_ts)
    _records.append(rec)
    _obs.counter("decision.total", _always=True, actor=rec.actor,
                 action=rec.action).add(1)
    entry = _Pending(rec, clk, clk + float(settle_s),
                     dict(signals or {}), probe, judge)
    if post_signals is not None:
        _pending.append(entry)
        _join(entry, post=dict(post_signals))
    else:
        _pending.append(entry)
    return rec.decision_id


def observe(actor: str, signals: dict, clock: Optional[float] = None):
    """Push the actor's current steady-state signals (the serving
    fleet's per-tick queue/p99, the supervisor's healthy-poll state).
    The joiner uses the newest observation strictly after a decision
    as its post-signals. No-op when disabled."""
    if not _enabled:
        return
    clk = time.monotonic() if clock is None else float(clock)
    _observations[str(actor)] = (clk, dict(signals))


def join_outcomes(now: Optional[float] = None,
                  force: bool = False) -> int:
    """Walk pending records whose settle window expired (all of them
    when `force` — drills and supervisor exit close the books) and
    stamp outcomes. Returns the number joined."""
    clk = time.monotonic() if now is None else float(now)
    joined = 0
    for entry in list(_pending):
        if force or clk >= entry.deadline:
            _join(entry)
            joined += 1
    return joined


def records(actor: Optional[str] = None) -> List[DecisionRecord]:
    out = list(_records)
    if actor is not None:
        out = [r for r in out if r.actor == actor]
    return out


def get(decision_id: str) -> Optional[DecisionRecord]:
    for r in _records:
        if r.decision_id == decision_id:
            return r
    return None


def pending_count() -> int:
    return len(_pending)


def outcome_counts() -> Dict[str, int]:
    return {v: _outcome_counts.get(v, 0) for v in OUTCOMES}


# -- dump --------------------------------------------------------------------

def default_dump_path(reason: str = "manual",
                      dump_dir: Optional[str] = None) -> str:
    """`decisions_<reason>_rank<r>_pid<p>.json` under the flight
    recorder's directory contract ($PD_FR_DIR unless overridden) — a
    later routine dump never clobbers another reason's or process's
    evidence."""
    d = dump_dir or default_dir()
    safe = "".join(c if c.isalnum() or c in "_.-" else "_"
                   for c in reason) or "manual"
    return os.path.join(
        d, f"decisions_{safe}_rank{_rank()}_pid{os.getpid()}.json")


def dump(path: Optional[str] = None, reason: str = "manual",
         out_dir: Optional[str] = None,
         extra: Optional[dict] = None) -> dict:
    """Write the ledger to JSON and return the doc. Works even when
    disabled (dumps whatever the ring holds) — the paper trail must
    never refuse to be written."""
    doc: Dict[str, Any] = {
        "version": 1,
        "reason": reason,
        "ts": time.time(),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "rank": _rank(),
        "world": _world(),
        "enabled": _enabled,
        "born_ts": _born_ts,
        "incarnation_ts": _incarnation_ts,
        "records": [r.as_dict() for r in _records],
        "pending": [p.rec.decision_id for p in _pending],
        "outcomes": outcome_counts(),
    }
    if extra:
        doc.update(extra)
    if path is None:
        path = default_dump_path(reason, dump_dir=out_dir)
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        doc["path"] = path
    except OSError:
        doc["path"] = None  # evidence still returned to the caller
    return doc


def glob_dumps(dump_dir: str) -> List[str]:
    import glob as _glob
    return sorted(_glob.glob(os.path.join(dump_dir,
                                          "decisions_*.json")))
