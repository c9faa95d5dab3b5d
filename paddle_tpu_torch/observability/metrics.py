"""StatRegistry metrics runtime: counters / gauges / histograms.

Reference: platform/monitor.h:44 (StatValue<T> registry, the STAT_ADD /
STAT_INT macros, ExportedStatValue dump). The reference's design point —
a named registry whose hot-path increment is cheap enough to leave in
production dispatch code — is kept, with two upgrades:

- a module-level enable gate (`_enabled`, one bool read) so a counter
  increment in a disabled build costs a function call and nothing else
  (the eager-dispatch hot path wires counters unconditionally and relies
  on this being ~sub-microsecond);
- thread-sharded counter cells (each thread increments its own cell, no
  lock, no contention; `value()` sums the shards) — the "lock-free-ish"
  promise monitor.h makes with std::atomic, delivered per-thread here
  because CPython has no cheap atomics.

Instrument kinds:
  Counter    monotonic, thread-sharded add()
  Gauge      last-write-wins set() (+ add() for monitor.h parity);
             values may be non-numeric (exporters skip those for
             Prometheus, keep them for JSONL)
  Histogram  thread-sharded count/sum/min/max plus a bounded,
             deterministically-decimated reservoir for percentiles

Naming scheme (DESIGN.md "Observability"): dot-separated
`<subsystem>.<metric>` with optional labels, e.g.
``counter("op.dispatch.total", op="matmul")``. The snapshot key renders
as ``op.dispatch.total{op=matmul}``. The one deliberately
Prometheus-flat name is ``train_recompiles_total`` (the recompile
sentinel's contract counter — grep-able across exporters unchanged).

Instruments created with ``always=True`` ignore the enable gate
(core.monitor's explicit stat() API and the recompile sentinel: both are
opted into by the caller, not blanket-wired into hot paths).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
    "enable", "disable", "enabled", "enabled_scope", "snapshot",
    "reset", "clear", "registry_size", "get",
]

_enabled = False          # the one-bool hot-path gate
_reg_lock = threading.Lock()
_REGISTRY: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], "_Instrument"] = {}

_RESERVOIR_CAP = 2048


def enable(on: bool = True):
    """Turn the wired hot-path instruments on (off by default: the
    framework never pays for telemetry nobody reads)."""
    global _enabled
    _enabled = bool(on)
    return _enabled


def disable():
    return enable(False)


def enabled() -> bool:
    return _enabled


@contextmanager
def enabled_scope(on: bool = True):
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    try:
        yield
    finally:
        _enabled = prev


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Instrument:
    kind = "?"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 always: bool = False):
        self.name = name
        self.labels = labels
        self.always = always

    @property
    def full_name(self) -> str:
        if not self.labels:
            return self.name
        # label VALUES may contain the rendering's own separators (an
        # HLO op path with commas); escape them so exporters._split_key
        # can split unambiguously. Keys are python identifiers (kwarg
        # names) and '=' only separates at the FIRST occurrence per
        # pair, so ',' and '\' are the only characters needing escape.
        esc = lambda v: v.replace("\\", "\\\\").replace(",", "\\,")
        lbl = ",".join(f"{k}={esc(v)}" for k, v in self.labels)
        return f"{self.name}{{{lbl}}}"

    def _on(self) -> bool:
        return _enabled or self.always


class _Cell:
    __slots__ = ("v",)

    def __init__(self):
        self.v = 0


class Counter(_Instrument):
    """Monotonic counter (StatValue<int64_t> + STAT_ADD analogue).
    Thread-sharded: add() touches only this thread's cell."""

    kind = "counter"

    def __init__(self, name, labels=(), always=False):
        super().__init__(name, labels, always)
        self._tls = threading.local()
        self._cells: List[_Cell] = []
        self._cells_lock = threading.Lock()

    def _cell(self) -> _Cell:
        c = getattr(self._tls, "cell", None)
        if c is None:
            c = _Cell()
            self._tls.cell = c
            with self._cells_lock:
                self._cells.append(c)
        return c

    def add(self, n=1):
        if not (_enabled or self.always):
            return self
        self._cell().v += n
        return self

    inc = add

    def value(self):
        with self._cells_lock:
            return sum(c.v for c in self._cells)

    def reset(self):
        with self._cells_lock:
            for c in self._cells:
                c.v = 0

    def dump(self) -> dict:
        return {"type": "counter", "value": self.value()}


class Gauge(_Instrument):
    """Last-write-wins value. add() keeps monitor.h's `stat += v`
    surface (core.monitor routes through this)."""

    kind = "gauge"

    def __init__(self, name, labels=(), always=False):
        super().__init__(name, labels, always)
        self._value: Any = 0
        self._lock = threading.Lock()

    def set(self, v):
        if not (_enabled or self.always):
            return self
        self._value = v
        return self

    def add(self, v=1):
        if not (_enabled or self.always):
            return self
        with self._lock:
            self._value += v
        return self

    def value(self):
        return self._value

    get = value

    def reset(self):
        self._value = 0

    def dump(self) -> dict:
        return {"type": "gauge", "value": self._value}


class _HistCell:
    __slots__ = ("count", "sum", "min", "max", "res", "stride", "skip")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.res: List[float] = []
        # deterministic decimation: when the reservoir fills, keep every
        # other sample and double the admission stride — bounded memory,
        # no RNG (reproducible percentiles for tests)
        self.stride = 1
        self.skip = 0


class Histogram(_Instrument):
    """Distribution instrument: count/sum/min/max plus a bounded
    reservoir for p50/p99 (the StepClock percentile contract, resident
    in the registry instead of a loop-local list)."""

    kind = "histogram"

    def __init__(self, name, labels=(), always=False):
        super().__init__(name, labels, always)
        self._tls = threading.local()
        self._cells: List[_HistCell] = []
        self._cells_lock = threading.Lock()

    def _cell(self) -> _HistCell:
        c = getattr(self._tls, "cell", None)
        if c is None:
            c = _HistCell()
            self._tls.cell = c
            with self._cells_lock:
                self._cells.append(c)
        return c

    def observe(self, v):
        if not (_enabled or self.always):
            return self
        c = self._cell()
        v = float(v)
        c.count += 1
        c.sum += v
        if v < c.min:
            c.min = v
        if v > c.max:
            c.max = v
        c.skip += 1
        if c.skip >= c.stride:
            c.skip = 0
            c.res.append(v)
            if len(c.res) >= _RESERVOIR_CAP:
                c.res = c.res[::2]
                c.stride *= 2
        return self

    def observe_many(self, vs):
        for v in vs:
            self.observe(v)
        return self

    def _merged(self):
        with self._cells_lock:
            cells = list(self._cells)
        count = sum(c.count for c in cells)
        total = sum(c.sum for c in cells)
        mn = min((c.min for c in cells if c.count), default=float("inf"))
        mx = max((c.max for c in cells if c.count), default=float("-inf"))
        res: List[float] = []
        for c in cells:
            res.extend(c.res)
        return count, total, mn, mx, sorted(res)

    def percentile(self, q: float) -> float:
        _, _, _, _, res = self._merged()
        if not res:
            return -1.0
        idx = min(len(res) - 1,
                  max(0, int(round(q / 100.0 * (len(res) - 1)))))
        return res[idx]

    def count(self) -> int:
        return self._merged()[0]

    def reset(self):
        with self._cells_lock:
            for c in self._cells:
                c.__init__()

    def dump(self) -> dict:
        count, total, mn, mx, res = self._merged()
        out = {"type": "histogram", "count": count,
               "sum": round(total, 6)}
        if count:
            out["min"] = round(mn, 6)
            out["max"] = round(mx, 6)
            for q, k in ((50.0, "p50"), (99.0, "p99")):
                idx = min(len(res) - 1,
                          max(0, int(round(q / 100.0 * (len(res) - 1)))))
                out[k] = round(res[idx], 6)
        return out


_KIND = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


def _get_or_create(kind: str, name: str, labels: Dict[str, Any],
                   always: bool):
    key = (name, _label_key(labels))
    inst = _REGISTRY.get(key)
    if inst is None:
        with _reg_lock:
            inst = _REGISTRY.get(key)
            if inst is None:
                inst = _KIND[kind](name, key[1], always=always)
                _REGISTRY[key] = inst
    if inst.kind != kind:
        raise TypeError(
            f"metric '{inst.full_name}' already registered as "
            f"{inst.kind}, requested {kind}")
    if always and not inst.always:
        inst.always = True
    return inst


def counter(name: str, _always: bool = False, **labels) -> Counter:
    """Get-or-create the named counter (STAT_INT registration)."""
    return _get_or_create("counter", name, labels, _always)


def gauge(name: str, _always: bool = False, **labels) -> Gauge:
    return _get_or_create("gauge", name, labels, _always)


def histogram(name: str, _always: bool = False, **labels) -> Histogram:
    return _get_or_create("histogram", name, labels, _always)


def get(name: str, **labels) -> Optional[_Instrument]:
    return _REGISTRY.get((name, _label_key(labels)))


def snapshot(prefix: Optional[str] = None) -> Dict[str, dict]:
    """ExportedStatValue dump: full_name -> typed value dict. The
    transport format every exporter (Prometheus/JSONL/chrome-trace) and
    the fleet aggregator consume."""
    out = {}
    with _reg_lock:
        insts = list(_REGISTRY.values())
    for inst in insts:
        if prefix is not None and not inst.name.startswith(prefix):
            continue
        out[inst.full_name] = inst.dump()
    return dict(sorted(out.items()))


def reset(prefix: Optional[str] = None):
    """Zero instrument values (registry membership is kept)."""
    with _reg_lock:
        insts = list(_REGISTRY.values())
    for inst in insts:
        if prefix is None or inst.name.startswith(prefix):
            inst.reset()


def clear():
    """Drop every instrument (test isolation; production code should
    prefer reset())."""
    with _reg_lock:
        _REGISTRY.clear()


def registry_size() -> int:
    return len(_REGISTRY)
