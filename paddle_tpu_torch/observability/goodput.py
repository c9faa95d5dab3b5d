"""Goodput accounting: where did the job's wall-clock actually go?

A pod job's cost is wall-clock × chips; its value is productive train
steps. Everything between is lost goodput, and naming the thief is the
first step of every stall postmortem. This module decomposes elapsed
wall-clock into a fixed taxonomy of disjoint buckets:

  train        inside a train step, minus other-category time that
               accrued during the step (flight_recorder.step_end does
               the subtraction) — the "productive" fraction
  compile      CUDA-graph captures (the engine's, the TrainStep's and
               generate's), fed by sentinel.count_capture
  checkpoint   save/load spans (distributed/checkpoint.py)
  dataloader   time the consumer spent BLOCKED on the prefetch queue
  stalled      watchdog-detected no-progress time
  other        elapsed − sum(above): orchestration, eval, idle

``report()`` returns seconds + fractions of elapsed (fractions sum to
~1.0 by construction — "other" closes the budget); ``publish()`` mirrors
them into ``goodput.*`` registry gauges so the existing Prometheus/JSONL
exporters and ``fleet.aggregate()`` carry them with zero new plumbing.

Accounting calls are per-step/per-span (low rate), so they are not
behind the hot-path gate themselves — the *call sites* in hot layers
gate on ``flight_recorder._enabled`` (one bool, the metrics' bar). Capture
durations are the exception: they accrue on every capture (rare events,
and a recapture storm must be attributable even if the recorder was off
when it started).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from . import metrics

__all__ = ["CATEGORIES", "GoodputTracker", "start", "reset", "account",
           "adjust", "span", "accrued", "accrued_other", "report",
           "publish"]

CATEGORIES = ("train", "compile", "checkpoint", "dataloader", "stalled")


class GoodputTracker:
    """Accumulates seconds per category against a wall-clock baseline."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self._t0: Optional[float] = None
            self._acc: Dict[str, float] = {c: 0.0 for c in CATEGORIES}

    def start(self, only_if_unset: bool = False):
        """Pin the elapsed-time baseline. only_if_unset keeps the first
        baseline when several layers race to arm the tracker."""
        with self._lock:
            if only_if_unset and self._t0 is not None:
                return
            self._t0 = time.monotonic()
            self._acc = {c: 0.0 for c in CATEGORIES}

    def account(self, category: str, seconds: float):
        if category not in self._acc:
            raise ValueError(
                f"unknown goodput category {category!r}; taxonomy is "
                f"{CATEGORIES}")
        if seconds <= 0:
            return
        with self._lock:
            if self._t0 is None:  # first accounted span arms the clock
                self._t0 = time.monotonic() - seconds
            self._acc[category] += float(seconds)

    def adjust(self, category: str, seconds: float):
        """Signed accrual, floored at zero — the watchdog's stalled
        bucket uses this to RETRACT seconds it claimed optimistically
        when another bucket (a checkpoint span landing in one lump at
        its end) turns out to own the same wall-clock."""
        if category not in self._acc:
            raise ValueError(
                f"unknown goodput category {category!r}; taxonomy is "
                f"{CATEGORIES}")
        with self._lock:
            if self._t0 is None and seconds > 0:
                self._t0 = time.monotonic() - seconds
            self._acc[category] = max(
                0.0, self._acc[category] + float(seconds))

    def accrued(self, category: str) -> float:
        return self._acc.get(category, 0.0)

    def accrued_other(self, category: str) -> float:
        """Sum accrued over every category EXCEPT `category` — the
        subtraction baseline train-span accounting uses to keep
        buckets disjoint."""
        return sum(v for c, v in self._acc.items() if c != category)

    def report(self, elapsed: Optional[float] = None) -> dict:
        with self._lock:
            acc = dict(self._acc)
            t0 = self._t0
        if elapsed is None:
            elapsed = 0.0 if t0 is None else time.monotonic() - t0
        out: Dict[str, float] = {"elapsed_seconds": round(elapsed, 6)}
        used = 0.0
        for c in CATEGORIES:
            sec = min(acc[c], elapsed) if elapsed > 0 else acc[c]
            out[f"{c}_seconds"] = round(acc[c], 6)
            frac = (sec / elapsed) if elapsed > 0 else 0.0
            key = "productive_fraction" if c == "train" \
                else f"{c}_fraction"
            out[key] = round(frac, 6)
            used += frac
        out["other_fraction"] = round(max(0.0, 1.0 - used), 6)
        return out


_tracker = GoodputTracker()


def start(only_if_unset: bool = False):
    _tracker.start(only_if_unset=only_if_unset)


def reset():
    _tracker.reset()


def account(category: str, seconds: float):
    _tracker.account(category, seconds)


def adjust(category: str, seconds: float):
    _tracker.adjust(category, seconds)


@contextmanager
def span(category: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _tracker.account(category, time.perf_counter() - t0)


def accrued(category: str) -> float:
    return _tracker.accrued(category)


def accrued_other(category: str) -> float:
    return _tracker.accrued_other(category)


def report(elapsed: Optional[float] = None) -> dict:
    return _tracker.report(elapsed)


def publish(elapsed: Optional[float] = None) -> dict:
    """Mirror the breakdown into goodput.* gauges (always-on: whoever
    calls publish() wants the numbers exported regardless of the
    hot-path gate) — Prometheus/JSONL exporters and fleet.aggregate()
    pick them up from the registry like any other instrument."""
    rep = report(elapsed)
    for k, v in rep.items():
        metrics.gauge(f"goodput.{k}", _always=True).set(v)
    return rep
