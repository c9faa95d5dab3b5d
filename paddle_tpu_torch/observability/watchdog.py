"""Hang watchdog: detect a job that stopped making progress and dump
the evidence while it is still hanging.

A wedged collective or a deadlocked host thread produces NO signal —
the step loop simply never returns, metrics stop updating, and the pod
burns chip-hours silently. The watchdog is a daemon heartbeat thread
that polls the flight recorder's step-progress state
(``flight_recorder.note_step`` feeds it from TrainStep and both
pipeline engines):

  stall  ⇔  seconds since the last completed step
            > max(min_timeout, timeout_factor × rolling step-time p99)

The p99 comes from the recorder's rolling window, so the threshold
adapts to the job's real cadence (a 40 s/step MoE run and a 50 ms/step
smoke share one config). On stall the watchdog

  1. records a ``watchdog.stall`` event and accounts the no-progress
     time to the goodput ``stalled`` bucket,
  2. dumps the flight recorder + per-thread stacks to PD_FR_DIR
     (the hung main thread's stack IS the diagnosis),
  3. best-effort pokes peer hosts so every rank dumps — cross-rank
     seq diffing needs all the black boxes (``tools/tpu_doctor.py``),
  4. calls the user's ``on_stall`` hook (page, abort, nothing).

It never kills the job: deciding whether a stall is fatal belongs to
the orchestrator (elastic launch / operator), not the telemetry layer.

Peer poke mechanics: every watchdog polls a shared poke file
(PD_FR_POKE_DIR, default PD_FR_DIR — on a pod this rides the same
shared filesystem checkpoints use); a stalled rank touches it, every
rank that sees it dumps once. A collective-based poke is deliberately
NOT used from this thread: gloo/ICI collectives pair by call order, and
a side-thread collective racing the (possibly mid-collective, wedged)
main thread could mispair streams on healthy ranks — the file poke is
wedge-proof precisely because it needs no cooperation from the hung
thread. ``request_fleet_dump()`` is the same mechanism callable from
operator code.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from . import flight_recorder as _fr
from . import goodput, metrics

__all__ = ["HangWatchdog", "request_fleet_dump", "poke_path"]

logger = logging.getLogger("paddle_tpu_torch.observability")


def poke_path() -> str:
    d = os.environ.get("PD_FR_POKE_DIR",
                       _fr.default_dir())
    return os.path.join(d, "DUMP_REQUESTED")


def request_fleet_dump(reason: str = "operator") -> str:
    """Ask every rank's watchdog to dump its black box (shared-FS
    poke file; ranks clear it is NOT required — watchdogs dump once
    per poke mtime)."""
    path = poke_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{reason} {time.time()}\n")
    return path


class HangWatchdog:
    """Daemon thread watching step progress; see module docstring.

    min_timeout: floor in seconds before warmup p99 data exists (and
    for jobs whose first step legitimately compiles for minutes, set it
    generously — compile time IS step time to the watchdog).
    """

    def __init__(self, min_timeout: float = 300.0,
                 timeout_factor: float = 5.0,
                 poll_interval: float = 5.0,
                 on_stall: Optional[Callable[[dict], None]] = None,
                 peer_poke: bool = True,
                 dump_dir: Optional[str] = None):
        self.min_timeout = float(min_timeout)
        self.timeout_factor = float(timeout_factor)
        self.poll_interval = float(poll_interval)
        self.on_stall = on_stall
        self.peer_poke = peer_poke
        self.dump_dir = dump_dir
        self.stall_count = 0
        self.last_dump: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stalled_since: Optional[float] = None
        self._stall_accounted = 0.0
        self._episode_claimed = 0.0
        self._other_accounted = 0.0
        self._last_poke_seen = 0.0

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return self
        # baseline on the poke file's current mtime: a stale poke left
        # on the shared FS by a previous run/incident must not make a
        # freshly started watchdog dump — only pokes AFTER start count
        try:
            self._last_poke_seen = os.path.getmtime(poke_path())
        except OSError:
            self._last_poke_seen = 0.0
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="pd-hang-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=self.poll_interval + 2.0)
            if t.is_alive():
                # wedged (a dump blocked on a hung shared-FS mount —
                # exactly this module's target environment): keep the
                # handle so start() can't run two watchdogs at once.
                # The thread sees _stop when it unwedges and exits;
                # start() works again after that.
                return
            self._thread = None

    # -- policy --------------------------------------------------------------
    def timeout(self) -> float:
        p99 = _fr.progress().get("step_s_p99")
        if p99:
            return max(self.min_timeout, self.timeout_factor * p99)
        return self.min_timeout

    def _dump_path(self, tag: str) -> Optional[str]:
        if self.dump_dir is None:
            return None  # flight_recorder's PD_FR_DIR default
        # one filename contract (tpu_doctor globs it) — never fork it
        return _fr.default_dump_path(tag, dump_dir=self.dump_dir)

    # -- the loop ------------------------------------------------------------
    def _run(self):
        while not self._stop.wait(self.poll_interval):
            try:
                self._check_peer_poke()
                self._check_progress()
            except Exception:  # the watchdog must never take down a job
                logger.exception("hang watchdog poll failed")

    def _check_peer_poke(self):
        if not self.peer_poke:
            return
        try:
            mtime = os.path.getmtime(poke_path())
        except OSError:
            return
        if mtime > self._last_poke_seen:
            self._last_poke_seen = mtime
            self.last_dump = _fr.dump(
                path=self._dump_path("poked"), reason="peer_poke")

    def _check_progress(self):
        prog = _fr.progress()
        age = prog.get("last_step_age_s")
        # other-bucket accrual baseline, refreshed EVERY poll: the
        # stalled bucket must not re-claim wall-clock another category
        # (a long checkpoint, a retrace) already accounted — no-step
        # time is only "stalled" net of that, else the goodput
        # fractions sum past 1.0
        other_now = goodput.accrued_other("stalled")
        other_prev, self._other_accounted = (self._other_accounted,
                                             other_now)
        if age is None:  # no step completed yet: nothing to watch
            return
        limit = self.timeout()
        if age <= limit:
            if self._stalled_since is not None:
                # recovered: close the episode. The tail between the
                # last poll and the completing step was already
                # attributed by step_end (train = wall minus the
                # stalled seconds that accrued mid-step) — accounting
                # more stall here would double-count. But a span that
                # landed in one lump SINCE the last stalled poll (a
                # ckpt_end right before the recovering step) owns
                # wall-clock the stalled bucket already claimed while
                # the span was in flight — retract it, capped at what
                # this episode actually claimed so we never eat a
                # previous episode's stalled seconds. Retraction may
                # overshoot by other-bucket accrual inside the
                # recovering step itself (≤ one step); the cheaper
                # error vs. leaving a whole checkpoint double-counted
                r = min(self._episode_claimed,
                        max(0.0, other_now - other_prev))
                if r > 0:
                    goodput.adjust("stalled", -r)
                self._episode_claimed = 0.0
                self._stalled_since = None
            return
        # stall detected
        now = time.monotonic()
        first = self._stalled_since is None
        if first:
            # reach back to where the step budget ran out (≤ one poll
            # interval ago — the first poll past the limit fires)
            self._stalled_since = now - (age - limit)
            self._stall_accounted = self._stalled_since
            self._episode_claimed = 0.0
        # the stalled bucket accrues incrementally so a dump taken
        # mid-hang already carries the loss so far — net of what other
        # buckets accrued over the same interval (other_prev was
        # stashed last poll, bounding the claimed window). Signed:
        # a span that lands in one lump at its end (ckpt_end) makes
        # the net NEGATIVE, retracting the stalled seconds claimed
        # while that span was still in flight
        delta = ((now - self._stall_accounted)
                 - (other_now - other_prev))
        # retraction capped at THIS episode's claim, mid-episode and at
        # recovery alike: adjust() floors the whole accumulator at
        # zero, so an uncapped negative delta (a 10-min checkpoint
        # landing in one lump while still stalled) would eat stalled
        # seconds a PREVIOUS episode legitimately claimed
        delta = max(delta, -self._episode_claimed)
        goodput.adjust("stalled", delta)
        self._episode_claimed = max(0.0, self._episode_claimed + delta)
        self._stall_accounted = now
        if not first:
            return  # one dump + poke per stall episode
        self.stall_count += 1
        metrics.counter("watchdog.stalls_total", _always=True).add(1)
        _fr.record("watchdog.stall", age_s=round(age, 3),
                   limit_s=round(limit, 3),
                   step_s_p99=prog.get("step_s_p99"))
        logger.warning(
            "hang watchdog: no step for %.1fs (limit %.1fs, p99 %s) — "
            "dumping flight recorder + stacks", age, limit,
            prog.get("step_s_p99"))
        self.last_dump = _fr.dump(
            path=self._dump_path("stall"), reason="watchdog_stall")
        if self.peer_poke:
            try:
                path = request_fleet_dump(reason="watchdog_stall")
                # skip our own poke by its ACTUAL mtime (a shared-FS
                # server clock can be skewed from host wall-clock; a
                # local time.time() guess could eat a real peer poke)
                self._last_poke_seen = os.path.getmtime(path)
            except OSError:
                logger.warning("hang watchdog: peer poke failed",
                               exc_info=True)
        if self.on_stall is not None:
            try:
                self.on_stall(self.last_dump)
            except Exception:
                logger.exception("on_stall hook failed")
