"""Request tracing: the serving fleet's per-request black box.

The training path has three forensics planes (metrics, the flight
recorder, step anatomy); the serving fleet only shipped aggregate
histograms — when p99 TTFT breaches, nothing could say *which*
requests were slow or *why* (class-queue wait vs prefill bucket vs
chunked decode vs an eviction replay vs a swap flip). This module is
the serving twin of step anatomy: every request accrues SPANS at the
token boundaries the serving modules already own, and three consumers
read them back:

  explain_tail          the tail-attribution engine — decomposes each
                        p99-cohort request's end-to-end latency into
                        disjoint components summing to ~1.0 of its
                        wall time and names the dominant one
  chrome_trace_events   request lanes (one lane per replica, spans
                        colored by component) merged into the host
                        trace through profiler.export_chrome_tracing
  BurnMeter             rolling-window SLO error-budget burn-rate
                        gauges (``serving.slo.burn_rate{window=}``,
                        multi-window fast/slow alerts in the SRE
                        style) — SupervisorPolicy.decide_scale's
                        forward-looking signal next to the
                        instantaneous p99

Span taxonomy (DESIGN.md "Request anatomy"); spans carry [t0, t1],
marks are points:

  span  queue        fleet class-queue wait: arrival -> dispatch
  span  admission    engine-local queue: engine submit -> admitted
  span  prefill      one bucketed prefill dispatch (bucket, width)
  span  decode       one chunked decode dispatch (replica, tick,
                     bucket, chunk)
  span  requeue      an eviction hop: evict -> re-dispatch
                     (replica_from, replica_to, kind crash|hang)
  span  swap_flip    a hot-weight-swap pause on the request's replica
  mark  submit / dispatch / evict / retire / shed / drop / swap_flip

Cost discipline is the flight recorder's, verbatim: one module bool
(``_enabled``) gates everything; a disabled ``record_span()`` is a
function call plus a bool read (<1 µs, tier-1-guarded); enabled writes
claim a ring slot from an ``itertools.count`` (atomic under the GIL —
no hot-path lock). The module imports no torch and no numpy: traces must
be readable while the card is wedged, exactly like the flight recorder.
"""
from __future__ import annotations

import itertools
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "ReqTracer", "enable", "disable", "enabled", "reset", "get_tracer",
    "record_span", "mark", "events", "timelines", "attribute",
    "explain_tail", "chrome_trace_events", "BurnMeter", "COMPONENTS",
]

_enabled = False            # the one-bool hot-path gate

_DEFAULT_CAPACITY = 8192

# the disjoint latency components attribution decomposes into;
# "other" is the closure (wall time no span claimed). "draft" is the
# speculative proposer's dispatch slice and "prefix_match" the radix
# admission slice — named so slow_decode/queue attribution can't
# silently absorb the raw-speed levers' own cost.
COMPONENTS: Tuple[str, ...] = ("queue", "admission", "prefix_match",
                               "prefill", "draft", "decode", "requeue",
                               "swap_flip")
_TERMINAL_MARKS = ("retire", "shed", "drop")


class ReqTracer:
    """Fixed-size ring of span/mark dicts (FlightRecorder's slot-claim
    discipline: ``next()`` on an itertools.count is atomic under the
    GIL, the slot write is a plain list store)."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._slots: List[Optional[dict]] = [None] * self.capacity
        self._pos = itertools.count()

    # -- hot path ------------------------------------------------------------
    def record_span(self, rid, comp: str, t0: float, t1: float,
                    **meta) -> int:
        pos = next(self._pos)
        meta["i"] = pos
        meta["rid"] = rid
        meta["comp"] = comp
        meta["t0"] = t0
        meta["t1"] = t1
        self._slots[pos % self.capacity] = meta
        return pos

    def mark(self, rid, event: str, t: Optional[float] = None,
             **meta) -> int:
        pos = next(self._pos)
        meta["i"] = pos
        meta["rid"] = rid
        meta["mark"] = event
        meta["t"] = time.perf_counter() if t is None else t
        self._slots[pos % self.capacity] = meta
        return pos

    # -- read side -----------------------------------------------------------
    def events(self) -> List[dict]:
        """Spans + marks oldest-first (the ring's resident tail)."""
        snap = [e for e in list(self._slots) if e is not None]
        return sorted(snap, key=lambda e: e["i"])

    def resize(self, capacity: int):
        capacity = int(capacity)
        if capacity == self.capacity:
            return
        slots: List[Optional[dict]] = [None] * capacity
        for e in self.events()[-capacity:]:   # oldest-first: newest wins
            slots[e["i"] % capacity] = e
        if capacity < self.capacity:          # racing record stays in-bounds
            self.capacity = capacity
            self._slots = slots
        else:
            self._slots = slots
            self.capacity = capacity

    def clear(self):
        self._slots = [None] * self.capacity
        self._pos = itertools.count()


_tracer = ReqTracer()


def get_tracer() -> ReqTracer:
    return _tracer


def enable(on: bool = True, capacity: Optional[int] = None):
    """Turn request tracing on (off by default — serving never pays
    for spans nobody reads)."""
    global _enabled
    if capacity is not None and capacity != _tracer.capacity:
        _tracer.resize(capacity)
    _enabled = bool(on)
    return _enabled


def disable():
    return enable(False)


def enabled() -> bool:
    return _enabled


def reset():
    """Drop buffered spans (test / bench-leg isolation)."""
    _tracer.clear()


def record_span(rid, comp: str, t0: float, t1: float, **meta) -> int:
    """Append one [t0, t1] span (no-op, <1 µs, when disabled)."""
    if not _enabled:
        return -1
    return _tracer.record_span(rid, comp, t0, t1, **meta)


def mark(rid, event: str, t: Optional[float] = None, **meta) -> int:
    """Append one point event (no-op, <1 µs, when disabled)."""
    if not _enabled:
        return -1
    return _tracer.mark(rid, event, t=t, **meta)


# -- timelines ----------------------------------------------------------------

def timelines(evts: Optional[List[dict]] = None) -> Dict[Any, dict]:
    """Group the ring into per-request timelines:
    ``{rid: {"arrival", "done", "spans": [...], "marks": [...]}}``.

    arrival = the ``submit`` mark (fleet arrival clock; the
    ``dispatch`` mark or earliest span is the fallback), done = the
    terminal mark (retire/shed/drop; latest span end as fallback).
    Requests with no time base yet (in flight) carry ``done=None``."""
    if evts is None:
        evts = _tracer.events()
    out: Dict[Any, dict] = {}
    for e in evts:
        tl = out.setdefault(e["rid"], {"arrival": None, "done": None,
                                       "spans": [], "marks": []})
        if "comp" in e:
            tl["spans"].append(e)
        else:
            tl["marks"].append(e)
            if e["mark"] == "submit":
                tl["arrival"] = e["t"]
            elif e["mark"] == "dispatch" and tl["arrival"] is None:
                tl["arrival"] = e["t"]
            elif e["mark"] in _TERMINAL_MARKS:
                tl["done"] = e["t"]
    for tl in out.values():
        if tl["arrival"] is None and tl["spans"]:
            tl["arrival"] = min(s["t0"] for s in tl["spans"])
        if tl["done"] is None and tl["spans"]:
            tl["done"] = max(s["t1"] for s in tl["spans"])
    return out


def _merged_duration(intervals: List[Tuple[float, float]]) -> float:
    """Union length of [t0, t1] intervals (a component must not
    double-count overlapping dispatches)."""
    if not intervals:
        return 0.0
    intervals.sort()
    total = 0.0
    cur0, cur1 = intervals[0]
    for a, b in intervals[1:]:
        if a > cur1:
            total += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    return total + (cur1 - cur0)


def attribute(timeline: dict) -> Optional[dict]:
    """Decompose ONE request's wall time (arrival -> done) into the
    component shares. Spans are clipped to the request's wall window
    and union-merged per component; ``other`` is the closure (wall
    time no span claimed), so the shares sum to 1.0 by construction
    (up to tiny cross-component overlap at dispatch boundaries — the
    receipt bar is ±0.02). Returns None when the request has no wall
    time yet."""
    t0, t1 = timeline.get("arrival"), timeline.get("done")
    if t0 is None or t1 is None or t1 <= t0:
        return None
    wall = t1 - t0
    per: Dict[str, List[Tuple[float, float]]] = {}
    for s in timeline["spans"]:
        a, b = max(s["t0"], t0), min(s["t1"], t1)
        if b > a:
            per.setdefault(s["comp"], []).append((a, b))
    comps = {c: _merged_duration(iv) for c, iv in per.items()}
    claimed = sum(comps.values())
    comps["other"] = max(0.0, wall - claimed)
    shares = {c: v / wall for c, v in comps.items() if v > 0 or
              c == "other"}
    dominant = max(shares, key=shares.get)
    return {"wall_ms": wall * 1e3, "components": shares,
            "dominant": dominant,
            "share_sum": sum(shares.values())}


def _percentile(vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile without numpy (the metrics-module
    convention — this file stays torch- and numpy-free)."""
    vs = sorted(vals)
    if not vs:
        return -1.0
    idx = min(len(vs) - 1,
              max(0, int(round(q / 100.0 * (len(vs) - 1)))))
    return vs[idx]


def explain_tail(evts: Optional[List[dict]] = None,
                 p: float = 99.0, max_cohort: int = 16) -> dict:
    """The "why was p99 slow" engine: pick the requests at or above
    the p-th percentile of end-to-end latency (the tail cohort,
    slowest first) and attribute each one. ``dominant_overall`` and
    ``cohort_components`` aggregate the cohort's component SECONDS
    (not its per-request shares), so one very slow request weighs what
    it costs. Eviction / shed / swap evidence across the WHOLE trace
    rides along — the breach-verdict path reads causes from here
    alone."""
    if evts is None:
        evts = _tracer.events()
    tls = timelines(evts)
    rows = []
    for rid, tl in tls.items():
        att = attribute(tl)
        if att is not None:
            rows.append((att["wall_ms"], rid, tl, att))
    report: Dict[str, Any] = {
        "p": p, "requests": len(rows), "cohort": [],
        "threshold_ms": -1.0, "dominant_overall": None,
        "cohort_components": {},
        "evictions": [], "shed": 0, "swap_flips": 0,
    }
    # trace-wide incident evidence (independent of the cohort cut)
    for tl in tls.values():
        for m in tl["marks"]:
            if m["mark"] == "evict":
                report["evictions"].append(
                    {"rid": m["rid"], "replica": m.get("replica"),
                     "kind": m.get("kind"), "t": m["t"]})
            elif m["mark"] == "shed":
                report["shed"] += 1
        report["swap_flips"] += sum(
            1 for s in tl["spans"] if s["comp"] == "swap_flip")
    if not rows:
        return report
    walls = [r[0] for r in rows]
    thr = _percentile(walls, p)
    report["threshold_ms"] = round(thr, 3)
    cohort = sorted((r for r in rows if r[0] >= thr), reverse=True,
                    key=lambda r: r[0])[:max_cohort]
    agg: Dict[str, float] = {}
    for wall_ms, rid, tl, att in cohort:
        entry = {
            "rid": rid, "e2e_ms": round(wall_ms, 3),
            "components": {c: round(v, 4)
                           for c, v in att["components"].items()},
            "dominant": att["dominant"],
            "share_sum": round(att["share_sum"], 4),
            "replicas": sorted({s.get("replica") for s in tl["spans"]
                                if s.get("replica") is not None}),
        }
        report["cohort"].append(entry)
        for c, v in att["components"].items():
            agg[c] = agg.get(c, 0.0) + v * wall_ms
    total = sum(agg.values()) or 1.0
    report["cohort_components"] = {
        c: round(v / total, 4) for c, v in sorted(agg.items())}
    report["dominant_overall"] = max(agg, key=agg.get)
    return report


# -- chrome-trace request lanes ----------------------------------------------

# chrome://tracing reserved color names per component — the lane
# coloring: requeue red, swap pauses orange
_CNAME = {
    "queue": "thread_state_runnable",
    "admission": "thread_state_iowait",
    "prefix_match": "rail_load",
    "prefill": "thread_state_running",
    "draft": "rail_idle",
    "decode": "good",
    "requeue": "terrible",
    "swap_flip": "bad",
}


def _lane(replica) -> int:
    # one lane per replica; replica-less (single-engine) spans share
    # lane 0 with replica 0
    return 0 if replica is None else int(replica)


def chrome_trace_events(evts: Optional[List[dict]] = None) -> list:
    """Request lanes for chrome://tracing: one lane (tid) per replica,
    spans as complete ("ph":"X") events colored by component, marks as
    instant events. Timestamps share the perf_counter µs base the
    exporters' metric counter marks use, so the lanes line up with the
    host trace profiler.export_chrome_tracing writes."""
    if evts is None:
        evts = _tracer.events()
    pid = os.getpid()
    out = []
    lanes = set()
    for e in evts:
        if "comp" in e:
            tid = _lane(e.get("replica"))
            lanes.add(tid)
            args = {k: v for k, v in e.items()
                    if k not in ("i", "t0", "t1", "comp")}
            ev = {"name": f"{e['comp']}:{e['rid']}", "ph": "X",
                  "ts": e["t0"] * 1e6,
                  "dur": max(e["t1"] - e["t0"], 0.0) * 1e6,
                  "pid": pid, "tid": tid, "cat": "reqtrace",
                  "args": args}
            cname = _CNAME.get(e["comp"])
            if cname:
                ev["cname"] = cname
            out.append(ev)
        else:
            tid = _lane(e.get("replica"))
            lanes.add(tid)
            out.append({"name": f"{e['mark']}:{e['rid']}", "ph": "i",
                        "s": "t", "ts": e["t"] * 1e6, "pid": pid,
                        "tid": tid, "cat": "reqtrace",
                        "args": {k: v for k, v in e.items()
                                 if k not in ("i", "t", "mark")}})
    for tid in sorted(lanes):
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid,
                    "args": {"name": f"serving replica {tid}"}})
    return out


# -- SLO error-budget burn rate ----------------------------------------------

class BurnMeter:
    """Rolling-window SLO error-budget burn-rate gauges, SRE-style.

    Each finished request either met its latency SLO or breached it;
    over a window, ``burn_rate = breach_fraction / error_budget``
    where ``error_budget = 1 - target`` (target = the fraction of
    requests that must meet the SLO). burn_rate 1.0 means the budget
    is being spent exactly as fast as it accrues; >1.0 means an
    eventual SLO violation is ALREADY in the data even if the
    instantaneous p99 looks fine — the forward-looking signal
    ``SupervisorPolicy.decide_scale`` reads next to the p99.

    ``alert()`` is the multi-window rule: every window (fast AND slow)
    must burn above ``alert_rate`` — the fast window alone pages on
    blips, the slow window alone pages long after the incident."""

    def __init__(self, budget: float = 0.01,
                 windows: Sequence[float] = (5.0, 60.0),
                 alert_rate: float = 1.0):
        if not windows:
            raise ValueError("BurnMeter needs at least one window")
        self.budget = max(1e-9, float(budget))
        self.windows = tuple(sorted(float(w) for w in windows))
        self.alert_rate = float(alert_rate)
        self._events: deque = deque()   # (ts, breached)

    def record(self, ts: float, breached: bool):
        self._events.append((float(ts), bool(breached)))
        horizon = self._events[-1][0] - self.windows[-1]
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def rates(self, now: Optional[float] = None) -> Dict[float, float]:
        """Per-window burn rate; -1.0 for a window with no finished
        requests yet (no data is not a zero burn)."""
        now = time.perf_counter() if now is None else float(now)
        out = {}
        for w in self.windows:
            evts = [b for t, b in self._events if t > now - w]
            if not evts:
                out[w] = -1.0
            else:
                out[w] = (sum(evts) / len(evts)) / self.budget
        return out

    def alert(self, now: Optional[float] = None) -> bool:
        rates = self.rates(now)
        return all(r > self.alert_rate for r in rates.values())
