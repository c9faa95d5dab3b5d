"""Worker heartbeat / failure detection (a copy of
paddle_tpu/distributed/fleet/utils/heartbeat.py, which uses only the
standard library).

Reference: operators/distributed/heart_beat_monitor.cc — the PS counts
each trainer's BATCH_BARRIER messages and marks a trainer dead when its
last beat is older than the timeout, completing the job without it.

Shape here: no PS exists, so the beat channel is the fleet HTTP
KV store (the same rendezvous substrate, fleet/utils/http_server.py
KVClient/KVServer). Each worker runs a HeartbeatWorker daemon PUTting a
monotonic counter under hb/<rank>; any process (typically rank 0 or the
launcher) runs a HeartbeatMonitor that sweeps the table and reports
workers whose beat has not advanced within `timeout`. Recovery is the
checkpoint story (distributed/checkpoint.py train_epoch_range: restart
and resume) — detection here, restoration there, matching the
reference's division of labor.
"""
from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Callable, Dict, List, Optional

from .http_server import KVClient

__all__ = ["HeartbeatWorker", "HeartbeatMonitor"]


class HeartbeatWorker:
    """Beats hb/<rank> on the fleet KV endpoint.

    Two modes: `interval > 0` starts a daemon thread (liveness beats —
    the process is up); `interval=None` disables the thread and the
    trainer calls `pulse()` per step (progress beats — the reference's
    BATCH_BARRIER semantics, where a hung-but-alive trainer stops
    beating and gets detected)."""

    def __init__(self, endpoint: str, rank: int,
                 interval: Optional[float] = 1.0):
        self.rank = int(rank)
        self.interval = None if interval is None else float(interval)
        self._kv = KVClient(endpoint,
                            timeout=max(1.0, self.interval or 1.0))
        self._stop = threading.Event()
        self._count = 0
        self._thread = None
        if self.interval is not None:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"heartbeat-{rank}")

    def start(self):
        if self._thread is not None:
            self._thread.start()
        return self

    def pulse(self):
        """One progress-tied beat (call per training step/batch)."""
        self._count += 1
        try:
            self._kv.put(f"hb/{self.rank}",
                         f"{self._count}:{time.time():.3f}")
        except Exception:
            pass  # transient KV unavailability: keep training

    def _run(self):
        while not self._stop.is_set():
            self._count += 1
            try:
                self._kv.put(f"hb/{self.rank}",
                             f"{self._count}:{time.time():.3f}")
            except Exception:
                pass  # transient KV unavailability: keep beating
            self._stop.wait(self.interval)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class HeartbeatMonitor:
    """Sweeps hb/<rank> keys; a worker whose counter stops advancing for
    `timeout` seconds is dead (heart_beat_monitor.cc:
    LostWorkerMonitor). Conservative by design: KV transport failures —
    and missing keys for a worker that has already beaten (a KV that
    restarted empty) — are inconclusive, never evidence of death."""

    def __init__(self, endpoint: str, world_size: int,
                 timeout: float = 10.0, startup_timeout: float = 120.0,
                 on_dead: Optional[Callable[[int], None]] = None,
                 max_parallel_gets: int = 16):
        self.world_size = int(world_size)
        self.timeout = float(timeout)
        # a worker that has NEVER beaten is still starting (importing,
        # compiling) — the stall clock only runs from its first beat,
        # like the reference counting from the first barrier message;
        # startup_timeout bounds a worker that never comes up at all
        self.startup_timeout = float(startup_timeout)
        self.on_dead = on_dead
        # per-request timeout derives from the monitor's own clock so a
        # slow KV can't stretch one sweep past the detection window
        self._kv = KVClient(endpoint,
                            timeout=max(0.5, min(2.0, self.timeout / 4)))
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=min(int(max_parallel_gets),
                            max(self.world_size, 1)))
        self._start = time.monotonic()
        self._last: Dict[int, tuple] = {}  # rank -> (count, local_ts)
        self._dead: set = set()

    def _fetch(self, rank: int):
        try:
            raw = self._kv.get(f"hb/{rank}")
        except Exception:
            return rank, "unreachable", None
        if raw is None:
            return rank, "missing", None
        return rank, "ok", raw.decode()

    def sweep(self) -> List[int]:
        """One pass (GETs fanned out in parallel); returns ranks newly
        detected dead."""
        now = time.monotonic()
        targets = [r for r in range(self.world_size)
                   if r not in self._dead]
        newly = []
        for rank, status, raw in self._pool.map(self._fetch, targets):
            if status == "unreachable":
                continue  # inconclusive: never kill on a KV outage
            prev = self._last.get(rank)
            if status == "missing":
                if prev is not None and prev[0] >= 0:
                    # has beaten before; an empty key now means the KV
                    # lost state, not that the worker died
                    continue
                count = -1
            else:
                count = int(raw.split(":")[0])
            # ANY counter change is a beat — a restarted worker resets
            # its counter to 1, which is life, not a stall
            if prev is None or count != prev[0]:
                self._last[rank] = (count, now)
                continue
            never_beat = prev[0] < 0
            limit = self.startup_timeout if never_beat else self.timeout
            ref_ts = self._start if never_beat else prev[1]
            if now - ref_ts > limit:
                self._dead.add(rank)
                newly.append(rank)
                if self.on_dead is not None:
                    self.on_dead(rank)
        return newly

    def revive(self, rank: int):
        """Forget a death verdict after the launcher restarts `rank`.

        The KV slot is reset to the never-beat sentinel so the rank gets
        the STARTUP grace period again — otherwise the stale pre-restart
        counter would put the restarted worker (still importing/
        compiling, or fast-forwarding past completed work without
        pulsing) on the short stall clock and re-kill it."""
        self._dead.discard(int(rank))
        self._last.pop(int(rank), None)
        self._start = time.monotonic()  # restart the startup clock
        try:
            self._kv.put(f"hb/{rank}", f"-1:{time.time():.3f}")
        except Exception:
            pass  # KV outage: conservative sweep logic still applies

    def close(self):
        """Release the GET fan-out pool; long-lived launchers create one
        monitor per job and would otherwise leak its threads."""
        self._pool.shutdown(wait=False)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def dead(self) -> List[int]:
        return sorted(self._dead)

    def alive(self) -> List[int]:
        return [r for r in range(self.world_size)
                if r not in self._dead]

    def watch(self, poll: float = 1.0, stop_event=None):
        """Blocking sweep loop until every worker is dead or stop_event
        fires; yields nothing — use on_dead for reactions."""
        stop_event = stop_event or threading.Event()
        while not stop_event.is_set() and \
                len(self._dead) < self.world_size:
            self.sweep()
            stop_event.wait(poll)
