"""Metric exporters: Prometheus text format, JSONL time series, chrome
trace counter marks, and the bench report bridge.

Reference parity: monitor.h's ExportedStatValue dump + tools/timeline.py
(chrome://tracing). The Prometheus text format is the pod-operations
surface (scrape the dump a MetricsLogger/obs_report writes per host);
JSONL is the offline time-series log the bench artifacts ride; chrome
counter events ("ph":"C") overlay metric values onto the host trace that
profiler.export_chrome_tracing already writes.

``emit_report`` is the one-code-path bridge of the bench report: a
report dict is flattened into ``<prefix>.*`` gauges, then rebuilt
FROM the registry snapshot — so the JSON a bench prints and the
JSONL/Prometheus series an operator scrapes are provably the same
numbers.
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Dict, Optional

from . import metrics

__all__ = ["to_prometheus", "write_prometheus", "validate_exposition",
           "JsonlExporter", "chrome_trace_events", "emit_report",
           "flatten_report", "unflatten_report"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str, prefix: str = "paddle_tpu") -> str:
    base = _NAME_RE.sub("_", name)
    return f"{prefix}_{base}" if prefix else base


def _escape_label_value(v) -> str:
    # Prometheus exposition: backslash, double-quote and newline must
    # be escaped inside label values (strict parsers reject the raw
    # forms — an un-escaped '"' truncates the value and corrupts every
    # line after it)
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_NAME_RE.sub("_", k)}="{_escape_label_value(v)}"'
        for k, v in labels)
    return "{" + inner + "}"


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _split_label_pairs(rest: str):
    """Split the registry's `k=v,k2=v2` label rendering on UNESCAPED
    commas, unescaping as we scan (full_name escapes ',' and '\\' in
    values — a naive split(',') broke every value carrying a comma,
    e.g. an HLO op path or a shape tuple)."""
    parts, buf = [], []
    i, n = 0, len(rest)
    while i < n:
        ch = rest[i]
        if ch == "\\" and i + 1 < n:
            buf.append(rest[i + 1])
            i += 2
            continue
        if ch == ",":
            parts.append("".join(buf))
            buf = []
            i += 1
            continue
        buf.append(ch)
        i += 1
    parts.append("".join(buf))
    return parts


def _split_key(full_name: str):
    if "{" in full_name:
        name, rest = full_name.split("{", 1)
        # exactly ONE closing brace belongs to the rendering —
        # rstrip("}") would also eat braces that END a value (an HLO
        # layout like 'f32[2,4]{1,0}')
        if rest.endswith("}"):
            rest = rest[:-1]
        # keys are identifiers, so '=' in a VALUE is unambiguous: only
        # the first '=' of each pair separates
        pairs = [p.split("=", 1) for p in _split_label_pairs(rest)]
        return name, [(p[0], p[1] if len(p) > 1 else "")
                      for p in pairs]
    return full_name, []


_EXPOSITION_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*",?)*\})?'
    r' [-+]?([0-9.eE+-]+|nan|inf)$')


def validate_exposition(text: str) -> int:
    """Strict-enough Prometheus text-format check: every line is a
    comment or ``name[{labels}] value`` with balanced, escaped labels.
    Returns the number of sample lines; raises ValueError on the
    first malformed line. ONE copy of the validity notion — the
    pulse-server scrape receipt (obs_report --pulse) and the tier-1
    tests both enforce exactly this."""
    n = 0
    for i, line in enumerate(text.splitlines()):
        if not line or line.startswith("#"):
            continue
        if not _EXPOSITION_SAMPLE_RE.match(line):
            raise ValueError(
                f"malformed exposition line {i}: {line!r}")
        n += 1
    return n


def to_prometheus(snap: Optional[Dict[str, dict]] = None,
                  prefix: str = "paddle_tpu") -> str:
    """Render a snapshot (the live registry's by default, or a
    fleet-merged one) in the Prometheus text exposition format: ONE
    renderer for both sources so they cannot drift. Counters ->
    counter, gauges -> gauge (non-numeric gauges skipped), histograms
    -> summary (quantile 0.5/0.99 + _count/_sum/_min/_max). A labeled
    family emits exactly one '# TYPE' line (strict parsers reject
    duplicates)."""
    if snap is None:
        snap = metrics.snapshot()
    lines = []
    seen_types = set()

    def typ(pname, kind):
        if pname not in seen_types:
            lines.append(f"# TYPE {pname} {kind}")
            seen_types.add(pname)

    for full, d in sorted(snap.items()):
        name, labels = _split_key(full)
        pname = _prom_name(name, prefix)
        lbl = _prom_labels(labels)
        t = d.get("type")
        if t in ("counter", "gauge"):
            if not _is_num(d.get("value")):
                continue
            typ(pname, t)
            lines.append(f"{pname}{lbl} {d['value']}")
        elif t == "histogram":
            typ(pname, "summary")
            for q, k in (("0.5", "p50"), ("0.99", "p99")):
                if k in d:
                    qlbl = _prom_labels(labels + [("quantile", q)])
                    lines.append(f"{pname}{qlbl} {d[k]}")
            lines.append(f"{pname}_count{lbl} {d.get('count', 0)}")
            lines.append(f"{pname}_sum{lbl} {d.get('sum', 0)}")
            for k in ("min", "max"):
                if k in d:
                    lines.append(f"{pname}_{k}{lbl} {d[k]}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str, snap: Optional[Dict[str, dict]] = None,
                     prefix: str = "paddle_tpu") -> str:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    text = to_prometheus(snap, prefix)
    with open(path, "w") as f:
        f.write(text)
    return path


class JsonlExporter:
    """Append-only JSONL time series: one record per write(), carrying
    the full (or prefixed) snapshot. Offline analogue of a Prometheus
    scrape — BENCH_* artifacts and MetricsLogger both ride this."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def write(self, snap: Optional[Dict[str, dict]] = None,
              step: Optional[int] = None,
              extra: Optional[dict] = None) -> dict:
        if snap is None:
            snap = metrics.snapshot()
        rec: Dict[str, Any] = {"ts": round(time.time(), 3)}
        if step is not None:
            rec["step"] = int(step)
        if extra:
            rec.update(extra)
        rec["metrics"] = {
            k: (d["value"] if d["type"] in ("counter", "gauge")
                else {kk: vv for kk, vv in d.items() if kk != "type"})
            for k, d in snap.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        return rec


def chrome_trace_events(snap: Optional[Dict[str, dict]] = None,
                        ts_us: Optional[float] = None) -> list:
    """Snapshot as chrome://tracing counter events ("ph":"C") so metric
    values sit on the same timeline as the profiler's host spans."""
    if snap is None:
        snap = metrics.snapshot()
    if ts_us is None:
        ts_us = time.perf_counter_ns() / 1000.0
    pid = os.getpid()
    events = []
    for full, d in snap.items():
        if d["type"] in ("counter", "gauge"):
            v = d["value"]
            if not _is_num(v):
                continue
            args = {"value": v}
        else:
            args = {k: d[k] for k in ("count", "p50", "p99")
                    if k in d}
            if not args:
                continue
        events.append({"name": f"metric:{full}", "ph": "C",
                       "ts": ts_us, "pid": pid, "args": args})
    return events


# -- bench report bridge -----------------------------------------------------

def flatten_report(report: dict, parent: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in report.items():
        key = f"{parent}.{k}" if parent else str(k)
        if isinstance(v, dict):
            out.update(flatten_report(v, key))
        else:
            out[key] = v
    return out


def unflatten_report(flat: Dict[str, Any]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split(".")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def emit_report(report: dict, jsonl_path: Optional[str] = None,
                prefix: str = "bench") -> dict:
    """Route a report dict through the metrics runtime and hand back
    the registry's view of it.

    Every leaf becomes a ``<prefix>.<dotted.path>`` gauge (non-numeric
    leaves ride as opaque gauge values — JSONL keeps them, Prometheus
    skips them), the snapshot is appended to `jsonl_path` when given,
    and the returned dict is REBUILT from the snapshot — so a caller
    that prints the return value has provably printed the same numbers
    the JSONL/Prometheus series carry. Keys must not contain '.'
    (dotted keys are the nesting separator)."""
    flat = flatten_report(report)
    for key, v in flat.items():
        # always-on gauges: flipping the process-global gate here would
        # briefly turn every wired hot path on (and could revert a
        # concurrent enable() on restore)
        metrics.gauge(f"{prefix}.{key}", _always=True).set(v)
    snap = metrics.snapshot(prefix=prefix + ".")
    flat_back = {full[len(prefix) + 1:]: d["value"]
                 for full, d in snap.items()
                 if d["type"] == "gauge" and full.startswith(prefix + ".")}
    # only the keys this report set (the registry may hold older runs)
    rebuilt = unflatten_report(
        {k: flat_back[k] for k in flat if k in flat_back})
    if jsonl_path:
        JsonlExporter(jsonl_path).write(snap=snap)
    return rebuilt
