"""Device-time attribution from a profiler trace: the measured tier
(counterpart of paddle_tpu/observability/xprof.py, the same names,
event dicts and result shapes).

``anatomy`` counts the step's FLOPs by scope; this module reads what the
card did: a ``torch.profiler`` Chrome trace (``export_chrome_trace``,
plain or gzip), its device events (kernels, copies, memsets) mapped back
to the anatomy taxonomy, and

  - per-scope device milliseconds,
  - busy and idle time (the device span minus the union of kernel
    intervals: launch gaps, host-bound stretches),
  - the comm-overlap receipt: of the device time in collectives (NCCL
    kernels), how much ran concurrently with compute on the same device
    and how much was exposed (``comm.overlap_fraction``).

A kernel's scope: the names in its own args first (``op_name`` and the
other keys the JAX module reads), then the ``gpu_user_annotation``
ranges that contain it on its device (torch.profiler projects every
``record_function`` range, so every ``anatomy.scope``, onto the device
timeline), innermost first, then its own name's tokens. A CUDA-graph
replay passes through no record_function range: its kernels read
``unattributed`` (anatomy.train_step_anatomy profiles an eager step for
that reason).

Inputs accepted: a directory (the newest ``*trace.json*`` under it), or
a trace file. The JAX module also parses XPlane protobufs, which no
torch tool writes; ``find_xplane`` keeps the JAX name and globs for the
traces torch writes. All functions here are pure functions on event
lists, so the CPU tests feed both packages the same synthetic events.
"""
from __future__ import annotations

import glob as _glob
import gzip
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Tuple

from . import anatomy, metrics

__all__ = [
    "find_xplane", "load_profile", "is_comm_kernel", "scope_of_event",
    "attribute_device_time", "overlap_receipt", "publish", "top_ops",
    "format_top_ops", "events_of",
]

# substrings that mark a device event as collective communication (NCCL
# kernel spellings, the JAX module's XLA ones, our fused grad-sync labels)
COMM_TOKENS = (
    "all-reduce", "all_reduce", "allreduce", "all-gather", "all_gather",
    "allgather", "reduce-scatter", "reduce_scatter", "all-to-all",
    "alltoall", "collective-permute", "collective_permute", "ppermute",
    "fused_allreduce", "psum", "collective", "nccl", "onerankreduce",
    "sendrecv",
)

# arg keys that may carry a scope path for an event
_ARG_KEYS = ("tf_op", "hlo_op", "long_name", "name", "op_name",
             "kernel_details")

_DEVICE_PLANE_TOKENS = ("/device:", "tpu", "gpu", "accelerator")

# torch.profiler's categories of work on the card; its record_function
# ranges on the device timeline are "gpu_user_annotation"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RANGE_CAT = "gpu_user_annotation"

# aggregate/marker lanes whose events span whole steps or modules
_AGGREGATE_LINE_TOKENS = ("xla modules", "module", "steps", "step",
                          "framework", "source", "xla traceme",
                          "scope range")


def _is_aggregate_line(line_name: str) -> bool:
    ln = (line_name or "").lower()
    return any(tok in ln for tok in _AGGREGATE_LINE_TOKENS)


def find_xplane(logdir: str) -> Optional[str]:
    """The newest profiler trace under logdir (``**/*trace.json*``:
    torch.profiler's Chrome traces, plain or gzip), or None."""
    hits = _glob.glob(os.path.join(logdir, "**", "*trace.json*"),
                      recursive=True)
    if not hits:
        return None
    return max(hits, key=os.path.getmtime)


# ---------------------------------------------------------------------------
# loading: a Chrome trace -> normalized event dicts
# ---------------------------------------------------------------------------
# Event: {"device": process name, "line": lane name, "name": str,
#         "ts": start us, "dur": duration us, "args": {str: str}}

def _containing(ranges, ts, end):
    """Names of the ranges [(start, end, name)] holding [ts, end],
    outermost first."""
    hold = [(s, -e, n) for s, e, n in ranges if s <= ts and end <= e]
    return [n for _, _, n in sorted(hold)]


def _load_trace_json(path: str) -> List[dict]:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        doc = json.load(f)
    raw = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    pid_names: Dict[int, str] = {}
    tid_names: Dict[Tuple[int, int], str] = {}
    for ev in raw:
        if ev.get("ph") == "M":
            nm = (ev.get("args") or {}).get("name", "")
            if ev.get("name") == "process_name":
                pid_names[ev.get("pid")] = str(nm)
            elif ev.get("name") == "thread_name":
                tid_names[(ev.get("pid"), ev.get("tid"))] = str(nm)
    device_pids = {p for p, n in pid_names.items()
                   if any(t in n.lower() for t in _DEVICE_PLANE_TOKENS)}
    ranges: Dict[object, List[Tuple[float, float, str]]] = {}
    kept = []
    for ev in raw:
        if ev.get("ph") != "X":
            continue
        pid = ev.get("pid")
        cat = ev.get("cat")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat == _RANGE_CAT:
            ranges.setdefault(pid, []).append((ts, ts + dur,
                                               str(ev.get("name", ""))))
            continue
        if cat is not None:
            if cat not in DEVICE_CATS:
                continue
        elif device_pids and pid not in device_pids:
            continue
        lname = tid_names.get((pid, ev.get("tid")), str(ev.get("tid")))
        if _is_aggregate_line(lname):
            continue
        kept.append((ev, pid, lname, ts, dur))
    events: List[dict] = []
    for ev, pid, lname, ts, dur in kept:
        args = {k: str(v) for k, v in (ev.get("args") or {}).items()}
        path_names = _containing(ranges.get(pid, ()), ts, ts + dur)
        if path_names and "op_name" not in args:
            args["op_name"] = "/".join(path_names)
        events.append({
            "device": pid_names.get(pid, str(pid)),
            "line": lname,
            "name": ev.get("name", ""),
            "ts": ts, "dur": dur, "args": args})
    return events


def load_profile(path: str) -> List[dict]:
    """Normalize a capture into device-event dicts: a directory (its
    newest trace) or a Chrome trace file (.json or .json.gz)."""
    if os.path.isdir(path):
        hit = find_xplane(path)
        if hit is None:
            raise FileNotFoundError(f"no *trace.json* under {path!r}")
        return _load_trace_json(hit)
    return _load_trace_json(path)


def events_of(prof) -> List[dict]:
    """The device events of a finished torch.profiler.profile, through
    its Chrome trace (written to a temporary file, read, removed)."""
    fd, path = tempfile.mkstemp(suffix=".trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return _load_trace_json(path)
    finally:
        os.unlink(path)


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------

def is_comm_kernel(name: str, args: Optional[dict] = None) -> bool:
    hay = name.lower()
    if args:
        hay += " " + " ".join(str(v).lower() for v in args.values())
    return any(tok in hay for tok in COMM_TOKENS)


def scope_of_event(ev: dict,
                   scopes: Optional[Iterable[str]] = None
                   ) -> Optional[str]:
    """Map one device event to the anatomy taxonomy: scope paths in the
    event args first (op_name carries the record_function ranges that
    hold the kernel), then the kernel name's own tokens."""
    args = ev.get("args") or {}
    for k in _ARG_KEYS:
        v = args.get(k)
        if v:
            sc = anatomy.scope_of_op_name(str(v), scopes)
            if sc is not None:
                return sc
    return anatomy.scope_of_op_name(
        ev.get("name", "").replace(".", "/"), scopes)


# ---------------------------------------------------------------------------
# interval math
# ---------------------------------------------------------------------------

def _merge(intervals: List[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _union_len(intervals: List[Tuple[float, float]]) -> float:
    return sum(e - s for s, e in _merge(intervals))


def _overlap_with(iv: Tuple[float, float],
                  merged: List[Tuple[float, float]]) -> float:
    s, e = iv
    got = 0.0
    for ms, me in merged:
        if me <= s:
            continue
        if ms >= e:
            break
        got += min(e, me) - max(s, ms)
    return got


# ---------------------------------------------------------------------------
# attribution + the overlap receipt
# ---------------------------------------------------------------------------

def overlap_receipt(events: List[dict]) -> dict:
    """Per device: comm intervals against the union of concurrent
    compute intervals on the same device. hidden = comm time with
    compute in flight; exposed = the rest."""
    comm_ms = hidden_ms = 0.0
    by_dev: Dict[str, List[dict]] = {}
    for ev in events:
        by_dev.setdefault(ev["device"], []).append(ev)
    for evs in by_dev.values():
        compute = _merge([(e["ts"], e["ts"] + e["dur"]) for e in evs
                          if not is_comm_kernel(e["name"], e["args"])])
        for e in evs:
            if not is_comm_kernel(e["name"], e["args"]):
                continue
            iv = (e["ts"], e["ts"] + e["dur"])
            comm_ms += e["dur"] / 1e3
            hidden_ms += _overlap_with(iv, compute) / 1e3
    exposed = comm_ms - hidden_ms
    return {
        "comm_ms": round(comm_ms, 6),
        "hidden_ms": round(hidden_ms, 6),
        "exposed_ms": round(exposed, 6),
        "overlap_fraction": (round(hidden_ms / comm_ms, 6)
                             if comm_ms > 0 else -1.0),
    }


def attribute_device_time(events: List[dict],
                          scopes: Optional[Iterable[str]] = None,
                          steps: int = 1) -> dict:
    """The device-time anatomy: per-scope ms (comm events land on their
    scope when one is named, else the ``comm`` row), busy/idle split,
    and the comm-overlap receipt. ``steps`` divides the per-step
    figures for multi-step captures."""
    steps = max(int(steps), 1)
    per: Dict[str, float] = {}
    span_ms = busy_ms = 0.0
    by_dev: Dict[str, List[Tuple[float, float]]] = {}
    for ev in events:
        sc = scope_of_event(ev, scopes)
        if sc is None:
            sc = "comm" if is_comm_kernel(ev["name"], ev["args"]) \
                else "unattributed"
        per[sc] = per.get(sc, 0.0) + ev["dur"] / 1e3
        by_dev.setdefault(ev["device"], []).append(
            (ev["ts"], ev["ts"] + ev["dur"]))
    for ivs in by_dev.values():
        busy_ms += _union_len(ivs) / 1e3
        span_ms += (max(e for _, e in ivs) - min(s for s, _ in ivs)) / 1e3
    total = sum(per.values())
    comm = overlap_receipt(events)
    return {
        "per_scope_ms": {k: round(v / steps, 6) for k, v in
                         sorted(per.items(), key=lambda kv: -kv[1])},
        "per_scope_share": {k: round(v / total, 6) if total else 0.0
                            for k, v in per.items()},
        "device_busy_ms": round(busy_ms / steps, 6),
        "device_span_ms": round(span_ms / steps, 6),
        "idle_ms": round(max(span_ms - busy_ms, 0.0) / steps, 6),
        "comm": comm,
        "devices": len(by_dev),
        "events": len(events),
        "steps": steps,
    }


def publish(result: dict, prefix: str = "anatomy"):
    """Gauges for the measured tier, always-on: ``comm.overlap_fraction``
    and the per-scope device ms."""
    comm = result.get("comm", {})
    metrics.gauge("comm.overlap_fraction", _always=True).set(
        comm.get("overlap_fraction", -1.0))
    metrics.gauge("comm.exposed_ms", _always=True).set(
        comm.get("exposed_ms", -1.0))
    metrics.gauge("comm.device_ms", _always=True).set(
        comm.get("comm_ms", -1.0))
    for name, ms in result.get("per_scope_ms", {}).items():
        metrics.gauge(f"{prefix}.device_ms", _always=True,
                      scope=name).set(ms)
    metrics.gauge(f"{prefix}.idle_ms", _always=True).set(
        result.get("idle_ms", -1.0))
    return result


# ---------------------------------------------------------------------------
# the top-list
# ---------------------------------------------------------------------------

def top_ops(events: List[dict], n: int = 15,
            steps: int = 1) -> List[Tuple[str, float]]:
    """Heaviest device ops as (name, ms/step)."""
    steps = max(int(steps), 1)
    tot: Dict[str, float] = {}
    for ev in events:
        tot[ev["name"]] = tot.get(ev["name"], 0.0) + ev["dur"]
    ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
    return [(name, us / 1e3 / steps) for name, us in ranked]


def format_top_ops(events: List[dict], n: int = 15,
                   steps: int = 1) -> str:
    lines = [f"top device ops over {steps} steps:"]
    for name, ms in top_ops(events, n=n, steps=steps):
        lines.append(f"  {ms:9.2f} ms/step  {name[:90]}")
    return "\n".join(lines)
