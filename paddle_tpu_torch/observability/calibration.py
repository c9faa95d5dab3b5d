"""The planner's absolute step-time estimate, its analytic half
(counterpart of paddle_tpu/observability/calibration.py).

``predict_step_time_s(..., calib=None)`` turns a candidate layout's
per-axis wire bytes and per-chip FLOPs into seconds from the JAX
package's nominal constants (``ANALYTIC``: a TPU v4-class chip's spec
sheet, not an H100's), decomposed into compute, comm and bubble, so the
planner's reports carry the same numbers in both packages.
``load_for`` reads the committed table (``tools/cost_calibration.json``,
or ``PD_COST_CALIBRATION``) and, as in the JAX package, is loud on a
(device_kind, topology) mismatch: the always-on
``planner.calibration_stale_total`` counter and one warning, then None,
so the caller ranks with the analytic constants. The committed table
was probed for a different device, so on the card (and on the CPU at
most device counts) the port takes that fallback. Ranking with a
matching table (the calibrated half: the probes, ``Calibration``'s
lookups and the audit loop) comes with ROADMAP.md item 17; a table that
matches raises NotImplementedError rather than be ignored.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from typing import Any, Dict, Mapping, Optional

from . import metrics as _obs

__all__ = ["ANALYTIC", "default_table_path", "topology_fingerprint",
           "device_identity", "load_table", "load_for",
           "predict_step_time_s", "PlanReceipt"]

#: the JAX package's nominal constants (a TPU v4-class chip: ~275 TF/s,
#: ~2.4 TB/s interconnect, ~1.2 TB/s HBM copy), kept so both packages'
#: analytic estimates agree; they describe no card the port runs on
ANALYTIC = {
    "flops_per_s": 2.75e14,
    "wire_bytes_per_s": 2.4e12,
    "latency_s": 1e-6,
    "hbm_bytes_per_s": 1.2e12,
}

_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def default_table_path() -> str:
    return os.environ.get(
        "PD_COST_CALIBRATION",
        os.path.join(_REPO, "tools", "cost_calibration.json"))


def topology_fingerprint(device_kind: str, n_devices: int) -> str:
    """The table's key: device kind x device count."""
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


def load_table(path: Optional[str] = None) -> Optional[dict]:
    path = path or default_table_path()
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _later():
    return NotImplementedError(
        "ranking with a calibration table (Calibration, the probes and "
        "the audit loop) is not ported yet: it comes with ROADMAP.md "
        "item 17; pass calibration=None for the analytic ranking")


def load_for(device_kind: Optional[str] = None,
             n_devices: Optional[int] = None,
             path: Optional[str] = None):
    """The committed table if it matches (device_kind, topology). A
    mismatch bumps ``planner.calibration_stale_total``, warns naming
    both identities and returns None (the analytic fallback); a match
    raises NotImplementedError (item 17)."""
    table = load_table(path)
    if table is None:
        return None
    if device_kind is None or n_devices is None:
        ident = device_identity()
        device_kind = device_kind or ident["device_kind"]
        n_devices = (n_devices if n_devices is not None
                     else ident["n_devices"])
    kind = str(table.get("device_kind", "unknown"))
    n = int(table.get("n_devices", 0))
    if kind == str(device_kind).lower() and n == int(n_devices):
        raise _later()
    _obs.counter("planner.calibration_stale_total", _always=True).add(1)
    warnings.warn(
        "cost_calibration table is STALE: committed for "
        f"{str(table.get('topology', ''))!r}, running on "
        f"{topology_fingerprint(device_kind, n_devices)!r} — "
        "falling back to analytic constants; regenerate with "
        "tools/planner_calibrate.py --write", stacklevel=2)
    return None


def predict_step_time_s(sizes: Mapping[str, int], dims,
                        wire_by_axis: Mapping[str, Mapping[str, float]],
                        calib=None, num_micro: int = 4,
                        compress: str = "none") -> Dict[str, float]:
    """One candidate layout -> absolute step-time estimate (seconds),
    decomposed into compute / comm / bubble, from the ANALYTIC constants.
    A single-device plan has no comm term, pp=1 no bubble."""
    if calib is not None:
        raise _later()
    dp = max(int(sizes.get("dp", 1)), 1)
    fsdp = max(int(sizes.get("fsdp", 1)), 1)
    tp = max(int(sizes.get("tp", 1)), 1)
    pp = max(int(sizes.get("pp", 1)), 1)
    n_dev = dp * fsdp * tp * pp

    tokens = max(float(dims.batch) * float(dims.seq), 1.0)
    flops_per_chip = 6.0 * float(dims.n_params) * tokens / n_dev
    compute_s = flops_per_chip / ANALYTIC["flops_per_s"]

    comm_s = 0.0
    for row in (wire_by_axis or {}).values():
        nbytes = float(row.get("bytes", 0.0))
        calls = max(int(row.get("calls", 1)), 1)
        if nbytes <= 0:
            continue
        comm_s += (nbytes / ANALYTIC["wire_bytes_per_s"]
                   + calls * ANALYTIC["latency_s"])

    bubble = ((pp - 1) / float(num_micro + pp - 1)) if pp > 1 else 0.0
    bubble_s = bubble / max(1.0 - bubble, 1e-6) * compute_s
    return {"compute_s": compute_s, "comm_s": comm_s, "bubble_s": bubble_s,
            "total_s": compute_s + comm_s + bubble_s}


@dataclasses.dataclass(frozen=True)
class PlanReceipt:
    """The prediction a plan carries: step time (both estimates, in
    seconds), per-chip HBM peak and wire bytes per step, and the identity
    it was made for. ``used`` names the estimate that ranked it."""
    sizes: Dict[str, int]
    predicted_step_time_s: float
    predicted_hbm_bytes: float
    predicted_wire_bytes: float
    analytic_step_time_s: float
    calibrated_step_time_s: Optional[float]
    used: str
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
