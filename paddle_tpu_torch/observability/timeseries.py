"""Fleet pulse: continuous time-series telemetry over the StatRegistry.

Every plane before this one is snapshot-at-exit: metrics reach an
operator through ``emit_report``/``write_prometheus`` AFTER a run ends,
or through flight-recorder dumps after it dies. This module makes the
registry a live signal: a background sampler (daemon thread, or the
caller's own cadence — ``ServingFleet`` ticks it, bench arms the
thread) snapshots ``metrics.snapshot()`` into per-key fixed-size rings
of ``(ts, value)`` points, from which derived streams answer "what is
the fleet doing RIGHT NOW":

  counters    -> the raw cumulative series plus ``rate()`` (per-second
                 delta over a trailing window — tokens/s, scrapes/s)
  gauges      -> the raw series plus ``gauge_stats()`` (min/mean/max/
                 last over a trailing window — queue depth, occupancy)
  histograms  -> three sub-streams per instrument (``:count``, ``:p50``,
                 ``:p99``) plus ``hist_delta()`` (count and percentile
                 movement over the window — TTFT drift between scrapes)

Cost discipline (the flight-recorder bar, verbatim): ONE module bool
(``_enabled``); a disabled ``sample()`` is a function call plus a bool
read (<1 µs, tier-1-guarded), so the per-tick wiring in
``ServingFleet._publish`` stays permanently. Enabled samples are
throttled to the configured cadence — a fleet ticking every few ms
cannot flood the rings — and the daemon thread (``thread=True``)
samples on its own clock for loops that don't tick (bench train legs,
elastic workers). This module imports no torch: the pulse must stay
readable while the pod wedges (``pulse_server`` serves these rings
from a plain stdlib HTTP thread for exactly that reason).

Ring sizing: ``capacity`` points per key (default 512). At the default
1 s cadence that is ~8.5 minutes of history per series; the serving
drills run 0.05-0.25 s cadences for seconds-long windows. Memory is
bounded: capacity × one (float, float) tuple per live series.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from . import metrics

__all__ = [
    "Ring", "enable", "disable", "enabled", "reset", "sample",
    "series", "keys", "rate", "gauge_stats", "hist_delta", "dump",
    "sample_count", "cadence",
]

_enabled = False            # the one-bool hot-path gate

_DEFAULT_CAPACITY = 512
_DEFAULT_CADENCE_S = 1.0


class Ring:
    """Fixed-size ring of ``(ts, value)`` points, oldest evicted first.

    SINGLE-WRITER by contract: every append comes through ``sample()``,
    which serializes concurrent samplers (daemon thread vs a fleet
    tick) under ``_sample_lock`` — appends themselves stay lock-free.
    Readers are lock-free: a read racing a write can at worst see one
    stale slot across a wrap — acceptable for telemetry, and
    ``points()`` snaps the slots in one slice."""

    __slots__ = ("capacity", "_slots", "_n")

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._slots: List[Optional[Tuple[float, float]]] = (
            [None] * self.capacity)
        self._n = 0

    def append(self, ts: float, value: float):
        self._slots[self._n % self.capacity] = (float(ts), float(value))
        self._n += 1

    @property
    def total(self) -> int:
        """Lifetime points written (wrap-proof)."""
        return self._n

    def __len__(self) -> int:
        return min(self._n, self.capacity)

    def points(self) -> List[Tuple[float, float]]:
        """Resident points, oldest first."""
        n, cap = self._n, self.capacity
        slots = list(self._slots)          # one-slice snap
        if n <= cap:
            return [p for p in slots[:n] if p is not None]
        start = n % cap
        out = slots[start:] + slots[:start]
        return [p for p in out if p is not None]

    def window(self, seconds: Optional[float] = None,
               now: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        pts = self.points()
        if seconds is None:
            return pts
        if now is None:
            now = pts[-1][0] if pts else time.time()
        lo = now - float(seconds)
        return [p for p in pts if p[0] >= lo]


# -- module state --------------------------------------------------------------

_lock = threading.Lock()          # ring-dict creation + enable/disable
_sample_lock = threading.Lock()   # serializes whole samples (writers)
_rings: Dict[str, Ring] = {}
_capacity = _DEFAULT_CAPACITY
_cadence = _DEFAULT_CADENCE_S
_last_ts = 0.0
_samples = 0
_thread: Optional[threading.Thread] = None
_stop = threading.Event()


def enable(cadence_s: float = _DEFAULT_CADENCE_S,
           capacity: int = _DEFAULT_CAPACITY,
           thread: bool = False) -> bool:
    """Arm the pulse plane. ``thread=True`` starts the daemon sampler
    (loops that don't tick — bench, elastic workers); without it the
    caller's own ``sample()`` calls (``ServingFleet`` per tick) drive
    the rings, throttled to ``cadence_s``."""
    global _enabled, _capacity, _cadence, _thread
    with _lock:
        if int(capacity) != _capacity:
            # re-arming with a new capacity resizes EXISTING rings too
            # (newest points kept) — otherwise old keys silently keep
            # the previous window length while new keys get the new one
            for key, r in list(_rings.items()):
                nr = Ring(int(capacity))
                for ts_, v in r.points()[-int(capacity):]:
                    nr.append(ts_, v)
                _rings[key] = nr
        _capacity = int(capacity)
        _cadence = float(cadence_s)
        _enabled = True
        if thread and (_thread is None or not _thread.is_alive()):
            _stop.clear()
            _thread = threading.Thread(target=_run,
                                       name="pd-pulse-sampler",
                                       daemon=True)
            _thread.start()
    return _enabled


def disable():
    """Disarm: stops the daemon thread; rings stay readable (an
    operator can still pull the last window after a run ends —
    ``reset()`` clears them)."""
    global _enabled, _thread
    _enabled = False
    _stop.set()
    t = _thread
    if t is not None:
        t.join(timeout=_cadence + 2.0)
        if not t.is_alive():
            _thread = None
    return _enabled


def enabled() -> bool:
    return _enabled


def cadence() -> float:
    return _cadence


def reset():
    """Drop every ring and the sample counters (test isolation)."""
    global _last_ts, _samples
    with _lock:
        _rings.clear()
        _last_ts = 0.0
        _samples = 0


def sample_count() -> int:
    return _samples


def _run():
    # floor the wait so cadence_s=0 (a valid throttle-off setting for
    # tick-driven callers) can't busy-spin the daemon thread
    while not _stop.wait(max(_cadence, 0.005)):
        try:
            sample(force=True)
        except Exception:   # the sampler must never take down a job
            pass


def _ring(key: str) -> Ring:
    r = _rings.get(key)
    if r is None:
        with _lock:
            r = _rings.get(key)
            if r is None:
                r = Ring(_capacity)
                _rings[key] = r
    return r


def sample(now: Optional[float] = None, force: bool = False
           ) -> Optional[int]:
    """One pulse: snapshot the registry into the rings. Gated on the
    module bool (disabled cost: one bool read), throttled to the
    cadence unless ``force`` (the daemon thread and deterministic
    tests force; the fleet's per-tick call relies on the throttle).
    Returns the number of series touched, or None when skipped."""
    if not _enabled:
        return None
    global _last_ts, _samples
    if now is None:
        now = time.time()
    # throttle BEFORE the lock: a tick-driven caller inside the
    # cadence window must stay a lock-free no-op (never queue behind
    # the daemon thread's full-registry snapshot); re-checked inside
    # for the race
    if not force and (now - _last_ts) < _cadence:
        return None
    # one whole-sample lock keeps the rings SINGLE-WRITER (the daemon
    # thread and a fleet tick racing would double-claim ring slots —
    # a lost point plus a stale out-of-order slot); held once per
    # cadence, never on the disabled or throttled paths
    with _sample_lock:
        if not force and (now - _last_ts) < _cadence:
            return None
        _last_ts = now
        _samples += 1
        snap = metrics.snapshot()
        touched = 0
        for full, d in snap.items():
            t = d.get("type")
            if t in ("counter", "gauge"):
                v = d.get("value")
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                _ring(full).append(now, v)
                touched += 1
            elif t == "histogram":
                _ring(f"{full}:count").append(now, d.get("count", 0))
                touched += 1
                for k in ("p50", "p99"):
                    if k in d:
                        _ring(f"{full}:{k}").append(now, d[k])
                        touched += 1
        # cold-path odometer (one bump per cadence, not per metric):
        # lets obs_report/healthz prove the sampler is actually running
        metrics.counter("pulse.samples_total", _always=True).add()
        return touched


# -- window queries ------------------------------------------------------------

def keys(prefix: Optional[str] = None) -> List[str]:
    with _lock:
        ks = list(_rings)
    if prefix:
        ks = [k for k in ks if k.startswith(prefix)]
    return sorted(ks)


def series(key: str, window: Optional[float] = None,
           now: Optional[float] = None
           ) -> Optional[List[Tuple[float, float]]]:
    """Ring contents for one key (``None`` when the key has never been
    sampled — the /series 404 contract)."""
    r = _rings.get(key)
    if r is None:
        return None
    return r.window(window, now=now)


def rate(key: str, window: Optional[float] = None,
         now: Optional[float] = None) -> Optional[float]:
    """Counter derivative: (last - first) / (t_last - t_first) over the
    trailing window, per second. None with <2 points or zero span;
    clamped at 0 (a registry reset mid-window is not a negative
    rate)."""
    pts = series(key, window, now=now)
    if not pts or len(pts) < 2:
        return None
    (t0, v0), (t1, v1) = pts[0], pts[-1]
    if t1 <= t0:
        return None
    return max(0.0, (v1 - v0) / (t1 - t0))


def gauge_stats(key: str, window: Optional[float] = None,
                now: Optional[float] = None) -> Optional[dict]:
    """Trailing-window stats for a gauge stream."""
    pts = series(key, window, now=now)
    if not pts:
        return None
    vs = [v for _, v in pts]
    return {"n": len(vs), "min": min(vs), "max": max(vs),
            "mean": sum(vs) / len(vs), "last": vs[-1]}


def hist_delta(key: str, window: Optional[float] = None,
               now: Optional[float] = None) -> Optional[dict]:
    """Histogram movement over the window: observation-count delta plus
    the latest p50/p99 and how far each moved since the window opened
    (registry histograms are cumulative — the delta is what happened
    RECENTLY, which is what a live operator asks)."""
    counts = series(f"{key}:count", window, now=now)
    if not counts:
        return None
    out = {"count": counts[-1][1],
           "count_delta": counts[-1][1] - counts[0][1]}
    for q in ("p50", "p99"):
        pts = series(f"{key}:{q}", window, now=now)
        if pts:
            out[q] = pts[-1][1]
            out[f"{q}_delta"] = pts[-1][1] - pts[0][1]
    return out


def dump(window: Optional[float] = None) -> Dict[str, list]:
    """Every ring's window as JSON-safe lists (the /series bulk form
    and the post-run artifact)."""
    return {k: [list(p) for p in (series(k, window) or [])]
            for k in keys()}
