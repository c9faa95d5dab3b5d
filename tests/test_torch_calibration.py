"""The port's calibration plane (paddle_tpu_torch/observability/
calibration.py) against the JAX package's, on the CPU.

The synthetic probe table (the CPU's closed-form probes) is identical to
the JAX one for the same identity, and to the committed
tools/cost_calibration.json; save_table/load_table round-trip it; the
Calibration accessors, predict_step_time_s (analytic and calibrated,
degenerate layouts included), relative_error, audit and audit_report
give the JAX package's values on the same inputs (equal, the receipts'
numbers at 1e-12 relative); load_for matches or is loud alike; and the
collective inventory the port reads from the comm planner prices the
buckets as comm._wire_bytes does.
"""
import json
import math
import os
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu.distributed.sharding import ModelDims as JDims
from paddle_tpu.observability import calibration as jcal
from paddle_tpu_torch.distributed import comm
from paddle_tpu_torch.distributed.sharding import ModelDims as TDims
from paddle_tpu_torch.observability import calibration as tcal
from paddle_tpu_torch.observability import metrics as pmetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = os.path.join(ROOT, "tools", "cost_calibration.json")
DIMS = dict(n_params=10_000_000, hidden=512, n_layers=8, seq=128, batch=8)


@pytest.fixture(autouse=True)
def _metrics():
    pmetrics.reset()
    yield
    pmetrics.reset()


@pytest.mark.parametrize("ident", [("cpu", 8), ("cpu", 1),
                                   ("nvidia h100 80gb hbm3", 4)])
def test_synthetic_table_is_the_jax_one(ident):
    t = tcal.build_table(*ident, synthetic=True)
    j = jcal.build_table(*ident, synthetic=True)
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)
    if ident == ("cpu", 8):
        with open(COMMITTED) as f:
            assert json.load(f) == t
    assert tcal.SCHEMA_VERSION == jcal.SCHEMA_VERSION
    assert (tcal.MATMUL_BUCKETS, tcal.PAYLOAD_TIERS, tcal.WIRE_DTYPES) == \
        (jcal.MATMUL_BUCKETS, jcal.PAYLOAD_TIERS, jcal.WIRE_DTYPES)


def test_save_and_load_round_trip(tmp_path):
    t = tcal.build_table("cpu", 8)
    path = tcal.save_table(t, str(tmp_path / "sub" / "cal.json"))
    assert tcal.load_table(path) == t == jcal.load_table(path)


def test_calibration_accessors_match_jax():
    table = tcal.build_table("cpu", 8)
    t, j = tcal.Calibration(table), jcal.Calibration(table)
    for attr in ("device_kind", "n_devices", "topology", "synthetic",
                 "hbm_bytes_per_s"):
        assert getattr(t, attr) == getattr(j, attr)
    assert t.matches("cpu", 8) and not t.matches("cpu", 4)
    for mnk in ((2, 2, 2), (64, 64, 64), (4096, 768, 3072),
                (2 ** 20, 2 ** 20, 2 ** 20)):
        assert t.matmul_flops(*mnk) == j.matmul_flops(*mnk)
    for axis in ("dp", "tp", "pp", "nonsense"):
        for nbytes, calls, dt in ((0, 1, "f32"), (1 << 14, 1, "f32"),
                                  (1 << 14, 4, "bf16"),
                                  (1 << 30, 3, "int8_ef"),
                                  (1 << 20, 0, "f32")):
            assert t.collective_s(axis, nbytes, calls, dt) == \
                j.collective_s(axis, nbytes, calls, dt)


@pytest.mark.parametrize("sizes,wire", [
    ({"dp": 1, "fsdp": 1, "tp": 1, "pp": 1}, {}),
    ({"dp": 1, "fsdp": 1, "tp": 8, "pp": 1},
     {"tp": {"bytes": 1 << 20, "calls": 16}}),
    ({"dp": 8, "fsdp": 1, "tp": 1, "pp": 1},
     {"dp": {"bytes": 1 << 22, "calls": 1}}),
    ({"dp": 2, "fsdp": 2, "tp": 1, "pp": 2},
     {"fsdp": {"bytes": 1 << 24, "calls": 3},
      "pp": {"bytes": 1 << 16, "calls": 8}}),
])
@pytest.mark.parametrize("compress", ["none", "bf16", "int8_ef"])
def test_predict_step_time_matches_jax(sizes, wire, compress):
    table = tcal.build_table("cpu", 8)
    for tc, jc in ((None, None), (tcal.Calibration(table),
                                  jcal.Calibration(table))):
        got = tcal.predict_step_time_s(sizes, TDims(**DIMS), wire, calib=tc,
                                       compress=compress)
        want = jcal.predict_step_time_s(sizes, JDims(**DIMS), wire,
                                        calib=jc, compress=compress)
        assert got.keys() == want.keys()
        for k in got:
            assert math.isclose(got[k], want[k], rel_tol=1e-12), k


@pytest.mark.parametrize("pair", [(100.0, 50.0), (0.0, 0.0), (None, 1.0),
                                  (1.0, None), (0.0, 10.0), (3.0, 3.0)])
def test_relative_error_matches_jax(pair):
    assert tcal.relative_error(*pair) == jcal.relative_error(*pair)


def _receipts(**kw):
    base = dict(sizes={"dp": 2, "fsdp": 1, "tp": 1, "pp": 1},
                predicted_step_time_s=1e-3, predicted_hbm_bytes=1e4,
                predicted_wire_bytes=512.0, analytic_step_time_s=1e-3,
                calibrated_step_time_s=1.2e-3, used="calibrated",
                device_kind="cpu", topology="cpu-2dev",
                calibration_match=True)
    base.update(kw)
    return tcal.PlanReceipt(**base), jcal.PlanReceipt(**base)


@pytest.mark.parametrize("measured", [
    {"step_time_s": 2e-3, "hbm_bytes": 1.5e4, "wire_bytes": 512.0},
    {"step_time_s": 2e-3, "wire_bytes": None},
    {"step_time_s": 1e-3, "hbm_bytes": 1e4, "wire_bytes": 0.0},
])
def test_audit_and_report_match_jax(measured, tmp_path):
    tr, jr = _receipts()
    assert tr.as_dict() == jr.as_dict()
    assert tcal.audit(tr, measured, publish=False) == \
        jcal.audit(jr, measured, publish=False)
    got = tcal.audit_report(tr, measured, platform="cpu", n_devices=2,
                            jsonl_path=str(tmp_path / "t.jsonl"),
                            publish=False)
    want = jcal.audit_report(jr, measured, platform="cpu", n_devices=2,
                             jsonl_path=str(tmp_path / "j.jsonl"),
                             publish=False)
    assert got == want


def test_audit_gauges_are_always_on():
    pmetrics.disable()
    tr, _ = _receipts()
    tcal.audit(tr, {"step_time_s": 2e-3, "hbm_bytes": 2e4,
                    "wire_bytes": 512.0})
    snap = pmetrics.snapshot()
    for m in ("step_time", "hbm_peak", "wire_bytes"):
        assert "planner.prediction_error{metric=%s}" % m in snap
    assert snap["planner.prediction_error{metric=step_time}"]["value"] \
        == 0.5


def test_load_for_matches_or_is_loud_alike(tmp_path):
    path = str(tmp_path / "cal.json")
    tcal.save_table(tcal.build_table("cpu", 8), path)
    got = tcal.load_for("cpu", 8, path=path)
    want = jcal.load_for("cpu", 8, path=path)
    assert got.table == want.table and got.topology == "cpu-8dev"
    for mod in (tcal, jcal):
        with pytest.warns(UserWarning, match="STALE"):
            assert mod.load_for("nvidia h100 80gb hbm3", 8,
                                path=path) is None
    assert pmetrics.counter("planner.calibration_stale_total",
                            _always=True).value() == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tcal.load_for("cpu", 8,
                             path=str(tmp_path / "missing.json")) is None


def test_hardware_probes_run_on_the_cpu(monkeypatch):
    """The non-synthetic path on the CPU (the card's on the chip; here
    over the small matmul buckets only): every probe returns a positive
    rate; one rank times no collective and takes the per-axis synthetic
    baselines, as the JAX probe does with one device."""
    monkeypatch.setattr(tcal, "MATMUL_BUCKETS", tcal.MATMUL_BUCKETS[:5])
    t = tcal.build_table("cpu", 1, synthetic=False)
    assert len(t["matmul_flops_per_s"]) == 5
    assert t["synthetic"] is False
    assert all(v > 0 for v in t["matmul_flops_per_s"].values())
    assert t["hbm_copy_bytes_per_s"] > 0
    for axis, tiers in t["collective"].items():
        for row in tiers.values():
            for r in row.values():
                assert r["bandwidth_bytes_per_s"] == round(
                    jcal._SYN_AXIS_BW[axis])
                assert r["latency_s"] == jcal._SYN_AXIS_LAT[axis]


@pytest.mark.parametrize("compress", ["f32", "bf16", "int8_ef"])
def test_collective_bytes_read_the_comm_plan(compress):
    rng = np.random.RandomState(0)
    grads = {"a": torch.from_numpy(rng.randn(33, 17).astype(np.float32)),
             "b": torch.from_numpy(rng.randn(300).astype(np.float32)),
             "c": torch.from_numpy(rng.randn(8, 8).astype(np.float32))}
    cfg = comm.CommConfig(compress=compress, bucket_bytes=256)
    got = tcal.compiled_collective_bytes(grads, cfg)
    specs = comm.build_buckets(grads, cfg.bucket_bytes)
    assert got["calls"] == len(specs) > 1
    assert got["total_bytes"] == sum(
        comm._wire_bytes("flat", compress, s.num_elements, 4, 256)
        for s in specs)
    assert got["by_op"] == {"all-reduce": {"calls": got["calls"],
                                           "bytes": got["total_bytes"]}}
