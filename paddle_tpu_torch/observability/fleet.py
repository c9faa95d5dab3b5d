"""Fleet aggregation: metric rollups across processes (counterpart of
paddle_tpu/observability/fleet.py).

Each process's metrics registry sees only itself. ``aggregate`` gathers
every process's snapshot (JSON) with
``torch.distributed.all_gather_object`` when a process group of world
> 1 exists, and takes the local snapshot alone otherwise; then merges:

  counters    summed
  gauges      numeric -> {sum, mean, min, max}; non-numeric -> first
  histograms  count/sum summed, min/max folded, p50/p99 merged as the
              count-weighted mean of host percentiles (approximate:
              exact pod percentiles would need the raw reservoirs)

``merge_partial`` is the skip-and-flag merge the serving fleet's
rollup uses (a dead replica's snapshot is None).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

from . import metrics

__all__ = ["aggregate", "merge_snapshots", "merge_partial"]


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def merge_snapshots(snaps: List[Dict[str, dict]]) -> Dict[str, dict]:
    """Reduce per-host snapshots into one pod rollup (pure function —
    unit-testable without a pod)."""
    out: Dict[str, dict] = {}
    for snap in snaps:
        for key, d in snap.items():
            t = d.get("type")
            cur = out.get(key)
            if cur is None:
                if t == "counter":
                    out[key] = {"type": "counter", "value": d["value"],
                                "hosts": 1}
                elif t == "gauge":
                    v = d["value"]
                    if _num(v):
                        out[key] = {"type": "gauge", "value": v,
                                    "sum": v, "min": v, "max": v,
                                    "hosts": 1}
                    else:
                        out[key] = {"type": "gauge", "value": v,
                                    "hosts": 1}
                else:
                    out[key] = dict(d)
                    out[key]["hosts"] = 1
                continue
            cur["hosts"] += 1
            if t == "counter":
                cur["value"] += d["value"]
            elif t == "gauge":
                v = d["value"]
                if _num(v) and "sum" in cur:
                    cur["sum"] += v
                    cur["min"] = min(cur["min"], v)
                    cur["max"] = max(cur["max"], v)
                    cur["value"] = cur["sum"] / cur["hosts"]
            else:  # histogram
                c_old, c_new = cur.get("count", 0), d.get("count", 0)
                for q in ("p50", "p99"):
                    if q in cur and q in d and (c_old + c_new):
                        cur[q] = ((cur[q] * c_old + d[q] * c_new)
                                  / (c_old + c_new))
                cur["count"] = c_old + c_new
                cur["sum"] = cur.get("sum", 0) + d.get("sum", 0)
                if "min" in d:
                    cur["min"] = min(cur.get("min", d["min"]), d["min"])
                if "max" in d:
                    cur["max"] = max(cur.get("max", d["max"]), d["max"])
    return dict(sorted(out.items()))


def merge_partial(snaps: List[Optional[Dict[str, dict]]]
                  ) -> Dict[str, dict]:
    """Skip-and-flag partial rollup: ``None`` entries — a dead or
    unresponsive source (replica/host) whose snapshot could not be
    fetched — are SKIPPED instead of failing or hanging the merge, and
    the result always carries ``fleet.sources_reporting`` /
    ``fleet.sources_skipped`` gauges so a partial rollup can never
    masquerade as a full one. Callers own the liveness probe (e.g.
    ``ServingFleet.aggregate``'s per-replica snapshot timeout); this
    is the pure merge half."""
    live = [s for s in snaps if s is not None]
    out = merge_snapshots(live)
    hosts = len(live) or 1
    out["fleet.sources_reporting"] = {
        "type": "gauge", "value": len(live), "hosts": hosts}
    out["fleet.sources_skipped"] = {
        "type": "gauge", "value": len(snaps) - len(live),
        "hosts": hosts}
    return out


def _world() -> int:
    try:
        import torch.distributed as dist
    except ImportError:
        return 1
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def aggregate(snap: Optional[Dict[str, dict]] = None) -> Dict[str, dict]:
    """Pod-level rollup of metric snapshots (this process's registry by
    default). With a process group of world > 1 every process must call
    it: it is a collective."""
    if snap is None:
        snap = metrics.snapshot()
    nproc = _world()
    if nproc <= 1:
        merged = merge_snapshots([snap])
    else:
        import torch.distributed as dist
        gathered: List[Optional[str]] = [None] * nproc
        dist.all_gather_object(gathered, json.dumps(snap, sort_keys=True))
        merged = merge_snapshots([json.loads(b) for b in gathered])
    merged["fleet.host_count"] = {"type": "gauge", "value": nproc,
                                  "hosts": nproc}
    return merged
