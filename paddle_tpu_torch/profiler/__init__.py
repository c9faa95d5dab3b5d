"""Profiler: RecordEvent spans, chrome-trace export, the step clock, and
device traces through torch.profiler (counterpart of
paddle_tpu/profiler, the same names and output).

Reference: platform/profiler.{h,cc} (RecordEvent RAII, push/pop
per-thread event stacks, Enable/DisableProfiler with sorted reports),
device_tracer.cc (CUPTI timeline) and tools/timeline.py (chrome://tracing
export).

Host-side spans are recorded here (framework overhead, data loading,
dispatch) in a Python list (the JAX package's pure-Python path; its
native C++ span collector is not part of the port); each span is also a
``torch.profiler.record_function`` range, so it shows in a device trace.
export_chrome_tracing writes the spans as a chrome trace. Device kernels
come from torch.profiler (CUPTI): start_trace/stop_trace write its
Chrome trace under the log directory, which observability.xprof reads.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

__all__ = ["RecordEvent", "Profiler", "start_profiler", "stop_profiler",
           "profiler_guard", "export_chrome_tracing", "summary",
           "SummaryDict", "start_trace", "stop_trace", "StepClock"]

_lock = threading.Lock()
_enabled = False
_events: List[dict] = []
_tls = threading.local()

class RecordEvent:
    """RAII span (reference profiler.h:127). Usable as context manager or
    decorator; nesting tracked per thread. With torch imported, the span
    is also a torch.profiler.record_function range."""

    def __init__(self, name: str, event_type: str = "UserDefined"):
        self.name = name
        self.event_type = event_type
        self._t0 = None
        self._range = None

    def begin(self):
        torch = sys.modules.get("torch")
        if torch is not None:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        if not _enabled:
            return self
        self._t0 = time.perf_counter_ns()
        depth = getattr(_tls, "depth", 0)
        _tls.depth = depth + 1
        self._depth = depth
        return self

    def end(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        if self._t0 is None:
            return
        # begin() bumped _tls.depth: unwind it even when stop_profiler()
        # landed between begin and end (the span itself is dropped)
        t1 = time.perf_counter_ns()
        _tls.depth = max(getattr(_tls, "depth", 1) - 1, 0)
        t0, self._t0 = self._t0, None
        if not _enabled:
            return
        with _lock:
            _events.append({
                "name": self.name, "cat": self.event_type,
                "ts": t0 / 1000.0, "dur": (t1 - t0) / 1000.0,
                "ph": "X", "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": {"depth": self._depth},
            })

    def __enter__(self):
        return self.begin()

    def __exit__(self, *exc):
        self.end()

    def __call__(self, fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*a, **k):
            with RecordEvent(self.name, self.event_type):
                return fn(*a, **k)
        return wrapper


def _default_path(name):
    return os.path.join(tempfile.gettempdir(), name)


def start_profiler(state="All", tracer_option="Default"):
    """reference profiler.py start_profiler parity."""
    global _enabled
    with _lock:
        _events.clear()
    _enabled = True


def stop_profiler(sorted_key="total", profile_path=None):
    """Stop recording spans, write them as a chrome trace to
    profile_path (default: "profile" under the temporary directory;
    "" writes nothing) and return summary(sorted_key)."""
    global _enabled
    _enabled = False
    if profile_path is None:
        profile_path = _default_path("profile")
    if profile_path:
        export_chrome_tracing(profile_path)
    return summary(sorted_key)


@contextmanager
def profiler_guard(state="All", sorted_key="total", profile_path=None):
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def _metric_marks():
    """Metric counter events for the host trace (observability overlay;
    empty when the metrics runtime is off or holds nothing — a process
    that never enabled metrics must not pay a dump reparse just because
    always-on instruments exist)."""
    try:
        from ..observability import exporters, metrics
        if not metrics.enabled() or not metrics.registry_size():
            return []
        return exporters.chrome_trace_events()
    except Exception:
        return []


def _reqtrace_lanes():
    """Serving request lanes (observability.reqtrace): one lane per
    replica, spans colored by latency component. Empty when request
    tracing is off — a training process must not pay a ring scan."""
    try:
        from ..observability import reqtrace
        if not reqtrace.enabled():
            return []
        return reqtrace.chrome_trace_events()
    except Exception:
        return []


def export_chrome_tracing(path: str):
    """Write chrome://tracing JSON (tools/timeline.py analogue). Metric
    values from the observability registry ride along as counter
    ("ph":"C") events, and serving request lanes (reqtrace spans, one
    lane per replica) merge onto the same timeline."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    out = path if path.endswith(".json") else path + ".json"
    marks = _metric_marks() + _reqtrace_lanes()
    with _lock:
        data = {"traceEvents": list(_events) + marks}
    with open(out, "w") as f:
        json.dump(data, f)
    return out


class SummaryDict(dict):
    """summary() result: a plain sorted dict of per-span stats plus a
    `truncated` flag (always False here: the Python collector keeps
    every span; the JAX package's native one can drop names)."""
    truncated = False


def summary(sorted_key="total"):
    """Aggregated per-span stats (DisableProfiler sorted report)."""
    agg: Dict[str, dict] = {}
    with _lock:
        evs = list(_events)
    for e in evs:
        s = agg.setdefault(e["name"], {"calls": 0, "total_us": 0.0,
                                       "max_us": 0.0})
        s["calls"] += 1
        s["total_us"] += e["dur"]
        s["max_us"] = max(s["max_us"], e["dur"])
    for s in agg.values():
        s["avg_us"] = s["total_us"] / max(s["calls"], 1)
    key = {"total": "total_us", "calls": "calls", "max": "max_us",
           "ave": "avg_us"}.get(sorted_key, "total_us")
    return SummaryDict(sorted(agg.items(), key=lambda kv: -kv[1][key]))


# -- orchestration-overhead budget ------------------------------------------

class StepClock:
    """Per-step host wall-clock with an orchestration-overhead budget.

    The pipeline engines' contract (reference section_worker.cc:34's
    tight loop) is that HOST orchestration — schedule bookkeeping, jit
    dispatch, transfer setup — must not steal meaningful time from the
    device. This clock measures it: wrap each train step in `step()`,
    optionally feed the engine's per-tick host times via `add_ticks`,
    then `orchestration_fraction(device_compute_s)` reports what part of
    the median step the device compute estimate cannot account for
    (host wall time minus device compute time, as a fraction).

        clock = profiler.StepClock()
        for _ in range(n):
            with clock.step():
                engine.train_batch(x, y)
            clock.add_ticks(engine.last_tick_ms)
        frac = clock.orchestration_fraction(serial_compute_seconds)
        stats = clock.stats()   # step/tick p50 + p99 in ms
    """

    def __init__(self):
        self.steps_s: List[float] = []
        self.ticks_ms: List[float] = []

    @contextmanager
    def step(self):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.steps_s.append(time.perf_counter() - t0)

    def add_ticks(self, ticks_ms):
        self.ticks_ms.extend(float(t) for t in ticks_ms)

    @staticmethod
    def _pct(xs, q):
        if not xs:
            return -1.0
        ys = sorted(xs)
        idx = min(len(ys) - 1, max(0, int(round(q / 100.0
                                                * (len(ys) - 1)))))
        return ys[idx]

    def step_ms(self, q: float = 50.0) -> float:
        return self._pct(self.steps_s, q) * 1e3 if self.steps_s else -1.0

    def tick_ms(self, q: float = 50.0) -> float:
        return self._pct(self.ticks_ms, q)

    def orchestration_fraction(self, device_compute_s: float) -> float:
        """(median step wall time - device compute estimate) / wall —
        the upper bound on what host orchestration can steal from an
        ideal speedup. Clamped at 0 (an estimate above the measured
        wall means measurement noise, not negative overhead)."""
        if not self.steps_s:
            return -1.0
        wall = self._pct(self.steps_s, 50.0)
        if wall <= 0.0:
            return -1.0
        return max(0.0, (wall - float(device_compute_s)) / wall)

    def stats(self, device_compute_s: Optional[float] = None) -> dict:
        out = {
            "steps": len(self.steps_s),
            "step_ms_p50": round(self.step_ms(50), 3),
            "step_ms_p99": round(self.step_ms(99), 3),
        }
        if self.ticks_ms:
            out["tick_ms_p50"] = round(self.tick_ms(50), 4)
            out["tick_ms_p99"] = round(self.tick_ms(99), 4)
        if device_compute_s is not None:
            out["orchestration_fraction"] = round(
                self.orchestration_fraction(device_compute_s), 4)
        return out

    def publish(self, prefix: str = "train",
                device_compute_s: Optional[float] = None) -> dict:
        """Push this clock's stats into the observability registry as
        `<prefix>.<stat>` gauges (the step/tick percentiles become
        scrapeable next to the engines' own histograms)."""
        from ..observability import metrics as _metrics
        stats = self.stats(device_compute_s)
        for k, v in stats.items():
            _metrics.gauge(f"{prefix}.{k}").set(v)
        return stats


# -- device-side traces (torch.profiler) --------------------------------------

_trace = None


def start_trace(log_dir=None):
    """Start a device trace (CUPTI through torch.profiler: the card's
    kernels, copies and record_function ranges, and the host's ops) into
    log_dir (default: "torch-trace" under the temporary directory);
    returns log_dir. stop_trace writes it."""
    global _trace
    import torch
    if _trace is not None:
        raise RuntimeError("a trace is already running: stop_trace() first")
    log_dir = log_dir or _default_path("torch-trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _trace = (prof, log_dir)
    return log_dir


def stop_trace():
    """Stop the trace start_trace began and write its Chrome trace as
    <log_dir>/trace_<pid>_<ns>.pt.trace.json (observability.xprof's
    load_profile reads the newest); returns its path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no trace is running: start_trace() first")
    prof, log_dir = _trace
    _trace = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path
