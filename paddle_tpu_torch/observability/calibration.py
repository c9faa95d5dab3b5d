"""Cost-model truth plane: calibrated planner predictions and the
measured-vs-predicted audit loop (counterpart of
paddle_tpu/observability/calibration.py, the same names, table schema,
gauges and receipts).

  probes       micro-benches of the achieved matmul FLOP/s per shape
               bucket (torch.matmul on the card), per-axis collective
               bandwidth and latency per payload tier and wire dtype
               (torch.distributed all-reduce, NCCL on the card, over the
               world; the dtype factors ride comm._wire_bytes), and HBM
               copy bandwidth, written to a table keyed by (device_kind,
               topology fingerprint). On the CPU the probes are
               SYNTHETIC: closed-form formulas over the same bucket
               keys, bit-identical to the JAX package's synthetic table.
               With one rank there is no collective to time: the
               collective rows take the synthetic baselines, as the JAX
               probe does with one device.
  prediction   ``predict_step_time_s`` converts a candidate layout's
               per-axis wire bytes and per-chip FLOPs into seconds, from
               the table (``Calibration``) or from nominal constants
               (``ANALYTIC``: a TPU v4-class chip's spec sheet, kept so
               both packages' analytic estimates agree; it describes no
               card the port runs on).
  audit        ``audit`` joins measured step time, HBM peak and wire
               bytes onto a ``PlanReceipt``: always-on
               ``planner.prediction_error{metric=}`` gauges, the error
               shares and the worst metric; ``audit_report`` is the same
               as one emit_report receipt.

``compiled_collective_bytes`` reads the collectives a program issues
from the comm planner's own wire accounting (comm._wire_bytes over the
bucket plan, the ``comm.wire_bytes`` counter), since the port has no
HLO: the JAX module reads them from a partitioned module's HLO.

``load_for`` is loud on a (device_kind, topology) mismatch: the
always-on ``planner.calibration_stale_total`` counter and one warning,
then None, so the caller ranks with the analytic constants.

torch is imported only inside the hardware probes.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import Any, Dict, Mapping, Optional

from . import metrics as _obs

__all__ = [
    "SCHEMA_VERSION", "ANALYTIC", "MATMUL_BUCKETS", "PAYLOAD_TIERS",
    "WIRE_DTYPES", "default_table_path", "topology_fingerprint",
    "device_identity", "build_table", "save_table", "load_table",
    "Calibration", "load_for", "predict_step_time_s", "PlanReceipt",
    "relative_error", "compiled_collective_bytes", "audit",
    "audit_report",
]

SCHEMA_VERSION = 1

#: the JAX package's nominal constants (a TPU v4-class chip: ~275 TF/s,
#: ~2.4 TB/s interconnect, ~1.2 TB/s HBM copy), kept so both packages'
#: analytic estimates agree; they describe no card the port runs on, and
#: the calibration table exists because they are wrong on any given one
ANALYTIC = {
    "flops_per_s": 2.75e14,
    "wire_bytes_per_s": 2.4e12,
    "latency_s": 1e-6,
    "hbm_bytes_per_s": 1.2e12,
}

#: matmul shape buckets: log2(M*N*K), clamped. One achieved-FLOP/s
#: entry per bucket — small matmuls never reach peak, and the planner's
#: compute term must know by how much on THIS device.
MATMUL_BUCKETS = tuple(range(10, 37, 2))

#: collective payload tiers: log2 ceiling of the PER-CALL payload
#: bytes ("t16" covers calls up to 64 KiB). Latency dominates the small
#: tiers, bandwidth the large ones — GC3's per-tier modeling.
PAYLOAD_TIERS = (12, 16, 20, 24, 28)

#: grad wire tiers, comm.py's taxonomy (f32 flat, bf16 halves the
#: bytes, int8_ef is ~1 byte/elt + block scales)
WIRE_DTYPES = ("f32", "bf16", "int8_ef")

#: the planner's logical axes (mirrors sharding.LOGICAL_AXES without
#: importing it: calibration stays import-light)
_AXES = ("dp", "fsdp", "tp", "pp")

_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def default_table_path() -> str:
    return os.environ.get(
        "PD_COST_CALIBRATION",
        os.path.join(_REPO, "tools", "cost_calibration.json"))


def topology_fingerprint(device_kind: str, n_devices: int) -> str:
    """The table's key: device kind × device count. Deliberately
    human-readable (it names the mismatch in staleness warnings)."""
    return f"{device_kind}-{int(n_devices)}dev"


def device_identity() -> Dict[str, Any]:
    """(device_kind, n_devices) of this rank's world: the card's name in
    lower case (or "cpu") and the number of ranks."""
    from ..distributed.env import get_world_size
    kind = "cpu"
    try:
        import torch
        if torch.cuda.is_available():
            kind = torch.cuda.get_device_name(0).lower()
    except Exception:
        pass
    return {"device_kind": kind, "n_devices": get_world_size()}


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

def _wire_bytes_per_elt(dtype: str) -> float:
    """Bytes-on-the-wire per f32 element for each wire tier, from
    comm.py's OWN accounting — the single source of truth the runtime
    bills with."""
    from ..distributed.comm import _wire_bytes
    compress = {"f32": "none", "bf16": "bf16",
                "int8_ef": "int8_ef"}[dtype]
    n = 1 << 20
    return round(_wire_bytes("flat", compress, n, 4, 256) / float(n), 6)


#: synthetic per-axis baselines (bytes/s, seconds): a plausible CPU
#: shared-memory "interconnect" — tp innermost/fastest, pp
#: point-to-point cheapest latency, dp/fsdp ring-bound. Closed-form so
#: the CPU table is bit-identical across probe runs.
_SYN_AXIS_BW = {"dp": 5.0e9, "fsdp": 6.0e9, "tp": 8.0e9, "pp": 1.0e10}
_SYN_AXIS_LAT = {"dp": 5e-05, "fsdp": 5e-05, "tp": 2e-05, "pp": 1e-05}
_SYN_PEAK_FLOPS = 8.0e10
_SYN_HBM_BW = 2.0e10


def _syn_matmul_eff(bucket: int) -> float:
    """Achieved/peak fraction rises with problem size: tiny matmuls
    are dispatch-bound, big ones approach peak."""
    lo, hi = MATMUL_BUCKETS[0], MATMUL_BUCKETS[-1]
    frac = (bucket - lo) / float(hi - lo)
    return round(0.05 + 0.85 * min(max(frac, 0.0), 1.0), 4)


def _syn_tier_eff(tier: int) -> float:
    """Effective-bandwidth fraction per payload tier: small payloads
    never fill the pipe."""
    lo, hi = PAYLOAD_TIERS[0], PAYLOAD_TIERS[-1]
    frac = (tier - lo) / float(hi - lo)
    return round(0.25 + 0.75 * min(max(frac, 0.0), 1.0), 4)


def _probe_matmul(synthetic: bool) -> Dict[str, float]:
    out = {}
    for b in MATMUL_BUCKETS:
        key = f"log2_mnk_{b:02d}"
        if synthetic:
            out[key] = round(_SYN_PEAK_FLOPS * _syn_matmul_eff(b))
            continue
        out[key] = _measure_matmul_bucket(b)
    return out


def _time_best(fn, repeats: int) -> float:
    """Best wall seconds of fn() over `repeats` (after one warm call),
    the card synchronised around each."""
    import time
    import torch
    sync = torch.cuda.synchronize if torch.cuda.is_available() \
        else (lambda: None)
    fn()
    sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def _probe_device():
    import torch
    return torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")


def _measure_matmul_bucket(bucket: int, repeats: int = 3) -> float:
    """Hardware path: time a square-ish f32 matmul of ~2**bucket MNK
    elements, best of N."""
    import torch
    side = max(int(round(2 ** (bucket / 3.0))), 8)
    a = torch.ones((side, side), dtype=torch.float32, device=_probe_device())
    best = _time_best(lambda: a @ a, repeats)
    return round(2.0 * side ** 3 / max(best, 1e-9))


def _probe_collectives(synthetic: bool) -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    for axis in _AXES:
        tiers: Dict[str, dict] = {}
        for t in PAYLOAD_TIERS:
            dtypes = {}
            for dt in WIRE_DTYPES:
                if synthetic:
                    bw = round(_SYN_AXIS_BW[axis] * _syn_tier_eff(t))
                    lat = _SYN_AXIS_LAT[axis]
                else:
                    bw, lat = _measure_collective(axis, t)
                dtypes[dt] = {
                    "bandwidth_bytes_per_s": bw,
                    "latency_s": lat,
                    "wire_bytes_per_elt": _wire_bytes_per_elt(dt),
                }
            tiers[f"t{t:02d}"] = dtypes
        out[axis] = tiers
    return out


def _measure_collective(axis: str, tier: int, repeats: int = 3):
    """Hardware path: time an all-reduce of a 2**tier-byte payload over
    every rank of the world (one flat group standing in for the logical
    axis). With one rank, or no process group, the synthetic baseline
    (nothing to time)."""
    import torch
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized() \
            or dist.get_world_size() < 2:
        return round(_SYN_AXIS_BW[axis]), _SYN_AXIS_LAT[axis]
    n = dist.get_world_size()
    elts = max((1 << tier) // 4, 8)
    x = torch.ones((elts,), dtype=torch.float32, device=_probe_device())
    best = _time_best(lambda: dist.all_reduce(x), repeats)
    moved = 2.0 * (n - 1) / n * elts * 4 * n
    return round(moved / max(best, 1e-9)), round(best / 10.0, 9)


def _probe_hbm(synthetic: bool) -> float:
    if synthetic:
        return round(_SYN_HBM_BW)
    import torch
    nbytes = 1 << 24
    a = torch.ones((nbytes // 4,), dtype=torch.float32,
                   device=_probe_device())
    best = _time_best(lambda: a + 1.0, 3)
    return round(2.0 * nbytes / max(best, 1e-9))


def build_table(device_kind: Optional[str] = None,
                n_devices: Optional[int] = None,
                synthetic: Optional[bool] = None) -> dict:
    """Run every probe and assemble the table. ``synthetic`` defaults
    to True on cpu (the deterministic, bit-reproducible path the
    acceptance test pins) and False elsewhere."""
    ident = device_identity()
    device_kind = (device_kind or ident["device_kind"]).lower()
    n_devices = int(n_devices if n_devices is not None
                    else ident["n_devices"])
    if synthetic is None:
        synthetic = device_kind.startswith("cpu")
    return {
        "version": SCHEMA_VERSION,
        "device_kind": device_kind,
        "n_devices": n_devices,
        "topology": topology_fingerprint(device_kind, n_devices),
        "synthetic": bool(synthetic),
        "matmul_flops_per_s": _probe_matmul(synthetic),
        "collective": _probe_collectives(synthetic),
        "hbm_copy_bytes_per_s": _probe_hbm(synthetic),
    }


def save_table(table: Mapping, path: Optional[str] = None) -> str:
    path = path or default_table_path()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_table(path: Optional[str] = None) -> Optional[dict]:
    path = path or default_table_path()
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# table accessors
# ---------------------------------------------------------------------------

class Calibration:
    """Typed view over one calibration table (nearest-bucket lookups,
    identity checks). Construct via ``load_for`` so staleness stays
    loud."""

    def __init__(self, table: Mapping):
        self.table = dict(table)

    @property
    def device_kind(self) -> str:
        return str(self.table.get("device_kind", "unknown"))

    @property
    def n_devices(self) -> int:
        return int(self.table.get("n_devices", 0))

    @property
    def topology(self) -> str:
        return str(self.table.get("topology", ""))

    @property
    def synthetic(self) -> bool:
        return bool(self.table.get("synthetic", False))

    def matches(self, device_kind: str, n_devices: int) -> bool:
        return (self.device_kind == str(device_kind).lower()
                and self.n_devices == int(n_devices))

    def matmul_flops(self, m: float, n: float, k: float) -> float:
        mnk = max(float(m) * float(n) * float(k), 2.0)
        b = int(round(math.log2(mnk)))
        b = min(max(b, MATMUL_BUCKETS[0]), MATMUL_BUCKETS[-1])
        if b % 2:  # buckets are even; round down to the nearest
            b -= 1
        row = self.table.get("matmul_flops_per_s") or {}
        return float(row.get(f"log2_mnk_{b:02d}",
                             ANALYTIC["flops_per_s"]))

    def collective_s(self, axis: str, nbytes: float, calls: int = 1,
                     dtype: str = "f32") -> float:
        """Seconds to move ``nbytes`` over ``axis`` in ``calls``
        collectives: per-call payload picks the tier, latency charges
        per call."""
        if nbytes <= 0 or calls <= 0:
            return 0.0
        per_call = nbytes / calls
        tier = PAYLOAD_TIERS[-1]
        for t in PAYLOAD_TIERS:
            if per_call <= (1 << t):
                tier = t
                break
        axes = self.table.get("collective") or {}
        row = ((axes.get(axis) or {}).get(f"t{tier:02d}") or {}).get(
            dtype if dtype in WIRE_DTYPES else "f32")
        if not row:
            return (nbytes / ANALYTIC["wire_bytes_per_s"]
                    + calls * ANALYTIC["latency_s"])
        bw = float(row.get("bandwidth_bytes_per_s") or
                   ANALYTIC["wire_bytes_per_s"])
        lat = float(row.get("latency_s") or ANALYTIC["latency_s"])
        return nbytes / max(bw, 1.0) + calls * lat

    @property
    def hbm_bytes_per_s(self) -> float:
        return float(self.table.get("hbm_copy_bytes_per_s")
                     or ANALYTIC["hbm_bytes_per_s"])


def load_for(device_kind: Optional[str] = None,
             n_devices: Optional[int] = None,
             path: Optional[str] = None) -> Optional[Calibration]:
    """Load the committed table IF it matches (device_kind, topology).
    A mismatch is LOUD — the always-on
    ``planner.calibration_stale_total`` counter bumps and one warning
    names both identities — and returns None so the caller falls back
    to analytic constants visibly, never silently."""
    table = load_table(path)
    if table is None:
        return None
    if device_kind is None or n_devices is None:
        ident = device_identity()
        device_kind = device_kind or ident["device_kind"]
        n_devices = (n_devices if n_devices is not None
                     else ident["n_devices"])
    calib = Calibration(table)
    if not calib.matches(device_kind, n_devices):
        _obs.counter("planner.calibration_stale_total",
                     _always=True).add(1)
        warnings.warn(
            "cost_calibration table is STALE: committed for "
            f"{calib.topology!r}, running on "
            f"{topology_fingerprint(device_kind, n_devices)!r} — "
            "falling back to analytic constants; regenerate with "
            "tools/planner_calibrate.py --write", stacklevel=2)
        return None
    return calib


# ---------------------------------------------------------------------------
# absolute-unit prediction
# ---------------------------------------------------------------------------

def predict_step_time_s(sizes: Mapping[str, int], dims,
                        wire_by_axis: Mapping[str, Mapping[str, float]],
                        calib: Optional[Calibration] = None,
                        num_micro: int = 4,
                        compress: str = "none") -> Dict[str, float]:
    """One candidate layout → absolute step-time estimate (seconds),
    decomposed into compute / comm / bubble. ``calib=None`` uses the
    ANALYTIC spec-sheet constants — same structure, different
    denominators, so the audit can report both in the same units.

    Degenerate layouts are first-class: a single-device plan has empty
    ``wire_by_axis`` (comm_s = 0), pp=1 collapses the bubble to 0, and
    every term stays finite for any sizes with axis >= 1.
    """
    dp = max(int(sizes.get("dp", 1)), 1)
    fsdp = max(int(sizes.get("fsdp", 1)), 1)
    tp = max(int(sizes.get("tp", 1)), 1)
    pp = max(int(sizes.get("pp", 1)), 1)
    n_dev = dp * fsdp * tp * pp

    tokens = max(float(dims.batch) * float(dims.seq), 1.0)
    flops_per_chip = 6.0 * float(dims.n_params) * tokens / n_dev
    tokens_local = max(tokens / (dp * fsdp), 1.0)
    m = tokens_local
    k = max(float(dims.hidden), 1.0)
    n = max(k / tp, 1.0)
    if calib is not None:
        achieved = calib.matmul_flops(m, n, k)
    else:
        achieved = ANALYTIC["flops_per_s"]
    compute_s = flops_per_chip / max(achieved, 1.0)

    dtype = {"none": "f32", "bf16": "bf16",
             "int8_ef": "int8_ef"}.get(compress, "f32")
    comm_s = 0.0
    for axis, row in (wire_by_axis or {}).items():
        nbytes = float(row.get("bytes", 0.0))
        calls = max(int(row.get("calls", 1)), 1)
        if nbytes <= 0:
            continue
        if calib is not None:
            comm_s += calib.collective_s(axis, nbytes, calls=calls,
                                         dtype=dtype)
        else:
            comm_s += (nbytes / ANALYTIC["wire_bytes_per_s"]
                       + calls * ANALYTIC["latency_s"])

    bubble = ((pp - 1) / float(num_micro + pp - 1)) if pp > 1 else 0.0
    bubble_s = bubble / max(1.0 - bubble, 1e-6) * compute_s

    return {
        "compute_s": compute_s,
        "comm_s": comm_s,
        "bubble_s": bubble_s,
        "total_s": compute_s + comm_s + bubble_s,
    }


# ---------------------------------------------------------------------------
# PlanReceipt + audit
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlanReceipt:
    """The falsifiable prediction a planner-built executable carries:
    step time (both estimates, in seconds), per-chip HBM peak and
    per-chip wire bytes per step, plus the calibration identity that
    produced it. ``used`` names which estimate ranked/ships as THE
    prediction."""
    sizes: Dict[str, int]
    predicted_step_time_s: float
    predicted_hbm_bytes: float
    predicted_wire_bytes: float
    analytic_step_time_s: float
    calibrated_step_time_s: Optional[float]
    used: str                      # "analytic" | "calibrated"
    device_kind: str
    topology: str
    calibration_match: bool
    breakdown: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {
            "sizes": dict(self.sizes),
            "predicted_step_time_s": self.predicted_step_time_s,
            "predicted_hbm_bytes": round(self.predicted_hbm_bytes),
            "predicted_wire_bytes": round(self.predicted_wire_bytes),
            "analytic_step_time_s": self.analytic_step_time_s,
            "calibrated_step_time_s": self.calibrated_step_time_s,
            "used": self.used,
            "device_kind": self.device_kind,
            "topology": self.topology,
            "calibration_match": self.calibration_match,
            "breakdown": dict(self.breakdown),
        }


def relative_error(pred: Optional[float],
                   meas: Optional[float]) -> Optional[float]:
    """Symmetric relative error in [0, 1): |p-m| / max(p, m). Defined
    as 0.0 when both sides are ~0 (the zero-comm layout case) and None
    when either side is missing — a missing plane is a JOIN failure,
    not a perfect prediction."""
    if pred is None or meas is None:
        return None
    p, m = float(pred), float(meas)
    hi = max(abs(p), abs(m))
    if hi <= 1e-12:
        return 0.0
    return abs(p - m) / hi


def compiled_collective_bytes(grads: Mapping[str, Any],
                              config=None) -> dict:
    """Collective inventory of one gradient sync from the comm planner's
    own wire accounting (the port has no HLO to read; the JAX module
    counts a partitioned module's collectives): the buckets
    comm.build_buckets packs the named ``grads`` into (tensors or
    shapes as numpy arrays), one fused all-reduce each, its payload
    priced by comm._wire_bytes under the CommConfig's compression.
    Returns {"total_bytes", "calls", "by_op"}."""
    from ..distributed import comm
    config = config or comm.CommConfig()
    total = 0.0
    calls = 0
    for spec in comm.build_buckets(dict(grads), config.bucket_bytes):
        total += float(comm._wire_bytes(
            "flat", config.compress, spec.num_elements,
            comm._itemsize(spec.dtype), config.int8_block))
        calls += 1
    by_op = {"all-reduce": {"calls": calls, "bytes": total}} if calls \
        else {}
    return {"total_bytes": total, "calls": calls, "by_op": by_op}


_AUDIT_METRICS = ("step_time", "hbm_peak", "wire_bytes")


def audit(receipt: "PlanReceipt",
          measured: Mapping[str, Optional[float]],
          publish: bool = True) -> Dict[str, Any]:
    """Join measured values onto a PlanReceipt and compute per-metric
    prediction errors + error shares. ``measured`` keys:
    ``step_time_s``, ``hbm_bytes``, ``wire_bytes`` (None/absent = that
    plane didn't report — recorded as unjoined, never as 0 error).

    Publishing (the default; the explicit audit call is the opt-in) is
    ALWAYS-ON by contract: ``planner.prediction_error{metric=}`` plus
    the predicted/measured pairs ride every exporter and the pulse
    rings whether or not the metrics gate is up — a mis-planning
    cost model must be visible even on a quiet fleet.
    """
    preds = {
        "step_time": receipt.predicted_step_time_s,
        "hbm_peak": receipt.predicted_hbm_bytes,
        "wire_bytes": receipt.predicted_wire_bytes,
    }
    meas = {
        "step_time": measured.get("step_time_s"),
        "hbm_peak": measured.get("hbm_bytes"),
        "wire_bytes": measured.get("wire_bytes"),
    }
    errors: Dict[str, Optional[float]] = {}
    for key in _AUDIT_METRICS:
        errors[key] = relative_error(preds[key], meas[key])

    joined = {k: v for k, v in errors.items() if v is not None}
    total_err = sum(joined.values())
    shares = {k: (round(v / total_err, 4) if total_err > 0 else 0.0)
              for k, v in joined.items()}
    worst = (max(joined, key=joined.get) if joined else None)

    if publish:
        for key in _AUDIT_METRICS:
            if errors[key] is not None:
                _obs.gauge("planner.prediction_error", _always=True,
                           metric=key).set(round(errors[key], 6))
            if meas[key] is not None:
                _obs.gauge("planner.measured", _always=True,
                           metric=key).set(float(meas[key]))
            _obs.gauge("planner.predicted", _always=True,
                       metric=key).set(float(preds[key]))

    return {
        "predicted": {k: float(v) for k, v in preds.items()},
        "measured": {k: (float(v) if v is not None else None)
                     for k, v in meas.items()},
        "prediction_error": {k: (round(v, 6) if v is not None
                                 else None)
                             for k, v in errors.items()},
        "error_share": shares,
        "worst": worst,
        "metrics_joined": len(joined),
        "used": receipt.used,
    }


def audit_report(receipt: "PlanReceipt",
                 measured: Mapping[str, Optional[float]],
                 platform: Optional[str] = None,
                 n_devices: Optional[int] = None,
                 jsonl_path: Optional[str] = None,
                 publish: bool = True) -> dict:
    """The audit as ONE emit_report-shaped receipt: metric
    ``planner_prediction_error`` IS the perf-ledger fingerprint.
    Headline ``value`` is the number of planes that joined (a dropped
    join is gated as a contract, not averaged away); the per-metric
    errors + the calibration identity contract ride in extras. Routed
    through ``exporters.emit_report`` so the printed numbers, the
    always-on gauges and the JSONL series are provably the same."""
    res = audit(receipt, measured, publish=publish)
    sizes = receipt.sizes
    n_dev = 1
    for s in sizes.values():
        n_dev *= max(int(s), 1)
    out = {
        "metric": "planner_prediction_error",
        "unit": "count",
        "value": res["metrics_joined"],
        "platform": platform or receipt.device_kind,
        "n_devices": int(n_devices if n_devices is not None else n_dev),
        "extras": {
            "layout": dict(sizes),
            # duplicated from the headline so the exact-better
            # *metrics_joined spec gates join-completeness (the
            # headline "value" key resolves to the generic relative
            # spec, which would let a 3→2 join drop pass)
            "metrics_joined": res["metrics_joined"],
            "prediction_error": {
                k: v for k, v in res["prediction_error"].items()
                if v is not None},
            "error_share": res["error_share"],
            "worst": res["worst"],
            "predicted": res["predicted"],
            "measured": {k: v for k, v in res["measured"].items()
                         if v is not None},
            "used": receipt.used,
            "calibration": {
                "match": 1 if receipt.calibration_match else 0,
                "topology": receipt.topology,
                "used_calibrated":
                    1 if receipt.used == "calibrated" else 0,
            },
            "analytic_step_time_s": receipt.analytic_step_time_s,
            "calibrated_step_time_s": receipt.calibrated_step_time_s,
        },
    }
    from . import exporters
    return exporters.emit_report(out, jsonl_path=jsonl_path,
                                 prefix="planner.audit")
