"""Flight recorder: the training job's black box.

When a pod job stops making progress — one rank skips a collective, a
host wedges mid-1F1B tick, a recompile storm eats the step budget —
counters (the StatRegistry) tell you *how much* but not *what
happened last*. The flight recorder keeps a fixed-size, lock-light ring
buffer of structured events from every wired layer:

  collective.enter / collective.exit   op, mesh axis, payload bytes and
                                       a monotonically increasing
                                       per-(axis, op) sequence number
                                       (collective._record wires this;
                                       counted at CALL time — eager
                                       collectives per execution,
                                       in-trace collectives once per
                                       trace, exactly _record's
                                       documented counting)
  step.begin / step.end                TrainStep and both pipeline
                                       engines, with durations
  ckpt.<save|load>.begin / .end        distributed/checkpoint.py
  dataloader.wait                      prefetch-queue block time
  recompile                            RecompileSentinel violations with
                                       the shape/dtype diff
  watchdog.stall / dump                hang forensics markers

The buffer is dumped to JSON on demand (``dump()``), on crash
(``sys.excepthook``), and on SIGTERM/SIGQUIT — with per-thread Python
stacks attached (the PyTorch NCCL flight-recorder shape: the dump from
every rank is mergeable, and ``tools/tpu_doctor.py`` diffs the
per-(axis, op) sequence numbers across ranks to name the diverging
rank and the last mismatched collective).

Cost discipline (same bar as the metrics'): everything hides behind
ONE module bool (``_enabled``); a disabled ``record()`` is a function
call plus a bool read (<1 µs, tier-1-guarded), so the wiring stays in
the eager-dispatch and collective hot paths permanently. Enabled
writes are lock-light: one ``itertools.count`` bump (atomic under the
GIL) claims a slot, the slot write is a plain list store — concurrent
recorders never block each other.

This module deliberately imports no torch: dumps must work while the
card is wedged (that is the whole point), and the crash handlers must be
installable before any backend exists.
"""
from __future__ import annotations

import itertools
import json
import os
import signal
import socket
import sys
import tempfile
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

from . import goodput

__all__ = [
    "FlightRecorder", "enable", "disable", "enabled", "record",
    "get_recorder", "reset", "collective_seq", "seq_table", "dump",
    "step_begin", "step_end", "ckpt_begin", "ckpt_end", "ckpt_async_end",
    "dataloader_wait", "progress", "install_crash_handlers",
    "uninstall_crash_handlers", "default_dump_path",
]

_enabled = False            # the one-bool hot-path gate
_sync_steps = True          # step brackets block_until_ready (see enable)

_DEFAULT_CAPACITY = 4096
_PROGRESS_WINDOW = 256      # step durations kept for the watchdog's p99


def _dist():
    """torch.distributed when it is already imported and its process
    group initialised (never imports it, never touches the card)."""
    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() and \
                dist.is_initialized():
            return dist
    except Exception:
        pass
    return None


def default_dir() -> str:
    """Where dumps go: $PD_FR_DIR, else pd_flight under the process's
    temporary directory ($TMPDIR)."""
    return os.environ.get("PD_FR_DIR") or os.path.join(
        tempfile.gettempdir(), "pd_flight")


def _rank() -> int:
    """Best-effort rank id: the launch env first, then an initialised
    torch.distributed process group (never imported here)."""
    for var in ("PADDLE_TRAINER_ID", "PD_RANK", "RANK"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    dist = _dist()
    return int(dist.get_rank()) if dist is not None else 0


def _world() -> int:
    for var in ("PADDLE_TRAINERS_NUM", "PD_WORLD", "WORLD_SIZE"):
        v = os.environ.get(var)
        if v is not None:
            try:
                return int(v)
            except ValueError:
                pass
    dist = _dist()
    return int(dist.get_world_size()) if dist is not None else 1


class FlightRecorder:
    """Fixed-size ring of event dicts.

    Writes claim a global position from an ``itertools.count`` (next()
    is atomic under the GIL — no lock on the hot path) and store into
    ``pos % capacity``; readers reconstruct order from the embedded
    positions. A torn read during an in-flight write can at worst see
    one stale slot — acceptable for forensics, and the dump path snaps
    the list in one slice.
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._slots: List[Optional[dict]] = [None] * self.capacity
        self._pos = itertools.count()
        # per-(axis, op) monotonically increasing collective sequence
        # numbers (the cross-rank divergence signal tpu_doctor diffs)
        self._seq: Dict[str, int] = {}
        self._seq_lock = threading.Lock()
        # step-progress state the hang watchdog polls. note_step runs
        # once per step (ms scale), not per event, so a lock here is
        # fine — and required: the watchdog thread sorts the window
        # while the train thread appends, and a full deque mutates on
        # every append (RuntimeError without the lock).
        self._progress_lock = threading.Lock()
        self._last_step_ts: Optional[float] = None
        self._step_durations: deque = deque(maxlen=_PROGRESS_WINDOW)
        self._steps = 0

    # -- hot path ------------------------------------------------------------
    def record(self, kind: str, **fields) -> int:
        pos = next(self._pos)
        fields["i"] = pos
        fields["t"] = time.time()
        fields["k"] = kind
        self._slots[pos % self.capacity] = fields
        return pos

    def next_seq(self, axis: Optional[str], op: str) -> int:
        key = f"{axis or '-'}|{op}"
        with self._seq_lock:
            n = self._seq.get(key, 0)
            self._seq[key] = n + 1
        return n

    # -- read side -----------------------------------------------------------
    def events(self) -> List[dict]:
        """Events oldest-first (only the ring's still-resident tail)."""
        snap = [e for e in list(self._slots) if e is not None]
        return sorted(snap, key=lambda e: e["i"])

    def seq_table(self) -> Dict[str, int]:
        with self._seq_lock:
            return dict(self._seq)

    def note_step(self, duration_s: float):
        with self._progress_lock:
            self._last_step_ts = time.monotonic()
            self._step_durations.append(float(duration_s))
            self._steps += 1

    def progress(self) -> dict:
        with self._progress_lock:
            durs = sorted(self._step_durations)
        prog = {"steps": self._steps, "last_step_age_s": None,
                "step_s_p50": None, "step_s_p99": None}
        if self._last_step_ts is not None:
            prog["last_step_age_s"] = time.monotonic() - self._last_step_ts
        if durs:
            prog["step_s_p50"] = durs[len(durs) // 2]
            prog["step_s_p99"] = durs[min(len(durs) - 1,
                                          int(len(durs) * 0.99))]
        return prog

    def resize(self, capacity: int):
        """Re-size the ring IN PLACE, preserving the newest resident
        events plus the seq table and step-progress state (untouched) —
        a second enable(capacity=N) mid-incident must not erase the
        black box. Slot collisions under the new modulus drop the older
        event (newest wins), same best-effort bar as the ring itself."""
        capacity = int(capacity)
        if capacity == self.capacity:
            return
        slots: List[Optional[dict]] = [None] * capacity
        for e in self.events()[-capacity:]:  # oldest-first: newest wins
            slots[e["i"] % capacity] = e
        # assignment order keeps a racing record() in-bounds: shrink
        # publishes the smaller modulus before the shorter list, grow
        # publishes the longer list before the larger modulus
        if capacity < self.capacity:
            self.capacity = capacity
            self._slots = slots
        else:
            self._slots = slots
            self.capacity = capacity

    def clear(self):
        self._slots = [None] * self.capacity
        self._pos = itertools.count()
        with self._seq_lock:
            self._seq.clear()
        with self._progress_lock:
            self._last_step_ts = None
            self._step_durations.clear()
            self._steps = 0


_recorder = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _recorder


def enable(on: bool = True, capacity: Optional[int] = None,
           crash_handlers: bool = False, sync_steps: bool = True):
    """Turn the forensics plane on (recorder events + goodput
    accounting ride the same bool). Off by default — the framework
    never pays for telemetry nobody reads. crash_handlers=True also
    chains the dump into sys.excepthook/SIGTERM/SIGQUIT (opt-in:
    a library must not seize process-global hooks by default).
    sync_steps=False skips the per-step block_until_ready in the step
    brackets: durations then measure dispatch, not device completion —
    use it when the surrounding code times its own loop with one final
    sync (bench.py) and must keep host/device overlap undistorted; the
    watchdog still detects hangs (a wedged device eventually blocks
    dispatch too), only its p99 threshold gets less precise."""
    global _enabled, _sync_steps
    if capacity is not None and capacity != _recorder.capacity:
        _recorder.resize(capacity)
    _enabled = bool(on)
    _sync_steps = bool(sync_steps)
    if _enabled:
        goodput.start(only_if_unset=True)
        if crash_handlers:
            install_crash_handlers()
    return _enabled


def disable():
    return enable(False)


def enabled() -> bool:
    return _enabled


def sync_steps() -> bool:
    """Should step brackets block until device-complete? (read by the
    TrainStep / pipeline-engine call sites)."""
    return _sync_steps


def reset():
    """Drop buffered events + seq counters (test isolation)."""
    _recorder.clear()


def record(kind: str, **fields) -> int:
    """Append one event (no-op, <1 µs, when disabled)."""
    if not _enabled:
        return -1
    return _recorder.record(kind, **fields)


def collective_seq(axis: Optional[str], op: str) -> int:
    return _recorder.next_seq(axis, op)


def seq_table() -> Dict[str, int]:
    return _recorder.seq_table()


def progress() -> dict:
    return _recorder.progress()


# -- wired-layer helpers (one gate read, then events + goodput) --------------

def step_begin(engine: str, step: int):
    """Returns an opaque token for step_end, or None when disabled."""
    if not _enabled:
        return None
    _recorder.record("step.begin", engine=engine, step=int(step))
    return (time.perf_counter(), goodput.accrued_other("train"))


def step_end(engine: str, step: int, token, loss=None):
    if token is None or not _enabled:
        return
    dt = time.perf_counter() - token[0]
    fields = {"engine": engine, "step": int(step),
              "dur_ms": round(dt * 1e3, 3)}
    if loss is not None:
        try:
            fields["loss"] = float(loss)
        except Exception:
            pass
    _recorder.record("step.end", **fields)
    # productive time = wall step time minus whatever other categories
    # (compile, mid-step checkpoint) accrued during the step — goodput
    # categories must stay disjoint so fractions sum to 1
    goodput.account("train", dt - (goodput.accrued_other("train")
                                   - token[1]))
    _recorder.note_step(dt)


def ckpt_begin(kind: str):
    if not _enabled:
        return None
    _recorder.record(f"ckpt.{kind}.begin")
    return time.perf_counter()


def ckpt_end(kind: str, token, nbytes: int = -1):
    if token is None or not _enabled:
        return
    dt = time.perf_counter() - token
    _recorder.record(f"ckpt.{kind}.end", dur_ms=round(dt * 1e3, 3),
                     bytes=int(nbytes))
    goodput.account("checkpoint", dt)


def ckpt_async_end(kind: str, dur_ms: float, nbytes: int = -1):
    """Close-out for a checkpoint write that ran on a BACKGROUND thread
    (distributed/checkpoint.py async_write): event only, no goodput
    accrual — the write overlapped training, and the blocking snapshot
    interval already claimed its (small) share via ckpt_end."""
    if not _enabled:
        return
    _recorder.record(f"ckpt.{kind}.async_end",
                     dur_ms=round(float(dur_ms), 3), bytes=int(nbytes))


def dataloader_wait(seconds: float):
    if not _enabled:
        return
    # sub-millisecond queue pops are the healthy steady state — they
    # accrue to goodput but don't burn ring slots (the black box keeps
    # the anomalies, not the heartbeat)
    if seconds > 1e-3:
        _recorder.record("dataloader.wait",
                         dur_ms=round(seconds * 1e3, 3))
    goodput.account("dataloader", seconds)


# -- dump --------------------------------------------------------------------

def default_dump_path(reason: str = "manual",
                      dump_dir: Optional[str] = None) -> str:
    """Per-(reason, rank, pid) path: a later routine dump must not
    os.replace away the mid-hang stall evidence from the same process.
    The `flight_<reason>_rank<r>_pid<p>.json` scheme is THE filename
    contract tools/tpu_doctor.py globs — every dump producer goes
    through here (dump_dir overrides $PD_FR_DIR)."""
    d = dump_dir or default_dir()
    safe = "".join(c if c.isalnum() or c in "_.-" else "_"
                   for c in reason) or "manual"
    return os.path.join(
        d, f"flight_{safe}_rank{_rank()}_pid{os.getpid()}.json")


def _thread_stacks() -> Dict[str, List[str]]:
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        label = f"{names.get(tid, 'unknown')}:{tid}"
        out[label] = [ln.rstrip("\n")
                      for ln in traceback.format_stack(frame)]
    return out


def dump(path: Optional[str] = None, reason: str = "manual",
         stacks: bool = True, extra: Optional[dict] = None) -> dict:
    """Write the black box to JSON and return it. Works even when
    disabled (dumps whatever the ring still holds) — a crash handler
    must never refuse to write the evidence."""
    doc: Dict[str, Any] = {
        "version": 1,
        "reason": reason,
        "ts": time.time(),
        "host": socket.gethostname(),
        "pid": os.getpid(),
        "rank": _rank(),
        "world": _world(),
        "enabled": _enabled,
        "events": _recorder.events(),
        "collective_seq": _recorder.seq_table(),
        "progress": _recorder.progress(),
        "goodput": goodput.report(),
    }
    if extra:
        doc.update(extra)
    if stacks:
        doc["stacks"] = _thread_stacks()
    if path is None:
        path = default_dump_path(reason)
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
    record("dump", reason=reason)
    return doc


# -- crash handlers ----------------------------------------------------------

_prev_excepthook = None
_prev_signal: Dict[int, Any] = {}
_handlers_installed = False


def _crash_excepthook(exc_type, exc, tb):
    try:
        dump(reason=f"crash:{exc_type.__name__}")
    except Exception:
        pass
    hook = _prev_excepthook or sys.__excepthook__
    hook(exc_type, exc, tb)


def _signal_handler(signum, frame):
    try:
        name = signal.Signals(signum).name
    except ValueError:
        name = str(signum)
    try:
        dump(reason=f"signal:{name}")
    except Exception:
        pass
    prev = _prev_signal.get(signum)
    if callable(prev):
        prev(signum, frame)
    elif prev == signal.SIG_DFL or prev is None:
        # SIG_DFL, or a handler installed outside the signal module
        # (signal.signal returned None — a C-level handler we cannot
        # call): restore the default and re-raise so the process dies
        # with the semantics the supervisor expects (SIGTERM must
        # still kill; swallowing it would strand the rank until
        # SIGKILL)
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def install_crash_handlers(signals=(signal.SIGTERM, signal.SIGQUIT),
                           faulthandler_log: Optional[str] = None):
    """Chain the black-box dump into sys.excepthook and SIGTERM/SIGQUIT
    (preemption + operator `kill -QUIT` forensics), and arm
    faulthandler for hard (C-level) crashes. Idempotent; previous
    handlers are chained, not replaced. Signal hooks are best-effort:
    only the main thread may install them."""
    global _prev_excepthook, _handlers_installed
    if _handlers_installed:
        return True
    _prev_excepthook = sys.excepthook
    sys.excepthook = _crash_excepthook
    for sig in signals:
        try:
            _prev_signal[sig] = signal.signal(sig, _signal_handler)
        except (ValueError, OSError):  # non-main thread / exotic platform
            pass
    try:
        import faulthandler
        # don't steal faulthandler from a harness that already owns it
        # (pytest arms it for its own timeout dumps)
        if not faulthandler.is_enabled():
            if faulthandler_log is None:
                faulthandler_log = os.path.join(
                    default_dir(),
                    f"faulthandler_rank{_rank()}_pid{os.getpid()}.log")
            os.makedirs(os.path.dirname(faulthandler_log), exist_ok=True)
            global _faulthandler_file
            _faulthandler_file = open(faulthandler_log, "w")
            faulthandler.enable(file=_faulthandler_file)
    except Exception:
        pass
    _handlers_installed = True
    return True


_faulthandler_file = None


def uninstall_crash_handlers():
    """Restore chained handlers (test isolation)."""
    global _prev_excepthook, _handlers_installed, _faulthandler_file
    if not _handlers_installed:
        return
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
    for sig, prev in list(_prev_signal.items()):
        try:
            # prev None = a C-level handler signal.signal() couldn't
            # return (and can't reinstall — signal(sig, None) raises
            # TypeError); SIG_DFL matches _signal_handler's chaining
            # semantics for that case
            signal.signal(sig, signal.SIG_DFL if prev is None else prev)
        except (ValueError, OSError):
            pass
    _prev_signal.clear()
    if _faulthandler_file is not None:  # only if WE armed faulthandler
        try:
            import faulthandler
            faulthandler.disable()
        except Exception:
            pass
        try:
            _faulthandler_file.close()
        except Exception:
            pass
        _faulthandler_file = None
    _handlers_installed = False
