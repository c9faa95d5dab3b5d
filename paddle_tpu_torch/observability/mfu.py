"""Throughput / MFU reporter (counterpart of
paddle_tpu/observability/mfu.py, the same names and gauges).

MFU (model FLOPs utilization) = achieved model FLOP/s over the card's
peak FLOP/s. The numerator's FLOPs per step come from
``torch.utils.flop_counter.FlopCounterMode`` over one call of the step
(``step_flops``), plus the FLOPs the flash-attention kernels are
credited with (ops/flash_attention.py attention_flops: the autograd
Function is invisible to FlopCounterMode). XLA's cost analysis, which
the JAX module reads, does not count the JAX package's Pallas calls
either (they carry no cost_estimate): so this figure counts attention
and the JAX one leaves it out. The denominator is the card's peak from
``PEAK_FLOPS_BY_KIND`` (override: PD_PEAK_FLOPS), times the device
count.

``ThroughputMeter`` is the per-step accumulator engines and callbacks
feed; it publishes ``throughput.examples_per_sec``, ``throughput.mfu``
and ``throughput.model_flops_per_step`` gauges plus an
``examples_total`` counter through the metrics registry.

What the JAX module reads from XLA and the port has no counterpart of:
``flops_of_compiled`` (a compiled executable's cost analysis); the
counted eager call takes its place.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Optional, Set

from . import metrics

logger = logging.getLogger("paddle_tpu_torch.observability")

__all__ = ["chip_peak_flops", "step_flops", "ThroughputMeter",
           "PEAK_FLOPS_BY_KIND"]

# dense bf16 peak FLOP/s per device by kind (public spec sheets): the
# JAX package's TPU rows, and the H100 SXM under the name
# torch.cuda.get_device_name() gives (989.4 TFLOP/s dense BF16, NVIDIA
# H100 data sheet); override with PD_PEAK_FLOPS for unlisted hardware
PEAK_FLOPS_BY_KIND = {
    "TPU v2": 45e12, "TPU v3": 123e12, "TPU v4": 275e12,
    "TPU v5 lite": 197e12, "TPU v5e": 197e12, "TPU v5p": 459e12,
    "TPU v6 lite": 918e12, "TPU v6e": 918e12,
    "NVIDIA H100 80GB HBM3": 989e12,
}

# CPU fallback: order-of-magnitude per-core f32 peak, so a CPU run still
# yields a finite MFU estimate
_CPU_CORE_PEAK = 5e10

# the default assumed for devices the table cannot name; every use is
# loud (warn once per kind, always-on counter)
_UNKNOWN_CHIP_GUESS = 275e12
_warned_kinds: Set[str] = set()


class _Device:
    """What chip_peak_flops reads of a device: kind and platform."""

    def __init__(self, kind: str, platform: str):
        self.device_kind, self.platform = kind, platform


def _default_device():
    import torch
    if torch.cuda.is_available():
        return _Device(torch.cuda.get_device_name(0), "gpu")
    return _Device("cpu", "cpu")


def chip_peak_flops(device=None, fallback: Optional[float] = None) -> float:
    """Peak FLOP/s for one device: PD_PEAK_FLOPS > the spec table (by
    ``device_kind``, a prefix match) > `fallback` when given > the CPU
    core estimate > the loud guess for an unidentifiable accelerator.
    `device` is anything with ``device_kind`` and ``platform`` (the
    default: card 0, or the CPU without one). The guess bumps the
    always-on ``mfu.peak_flops_guess_total`` counter and warns once per
    kind."""
    env = os.environ.get("PD_PEAK_FLOPS")
    if env:
        return float(env)
    if device is None:
        device = _default_device()
    kind = getattr(device, "device_kind", "") or ""
    for k, v in PEAK_FLOPS_BY_KIND.items():
        if kind.lower().startswith(k.lower()):
            return v
    if fallback is not None:
        return fallback
    if getattr(device, "platform", "") == "cpu":
        return _CPU_CORE_PEAK * (os.cpu_count() or 1)
    metrics.counter("mfu.peak_flops_guess_total", _always=True).add(1)
    if kind not in _warned_kinds:
        _warned_kinds.add(kind)
        logger.warning(
            "chip_peak_flops: unrecognized device_kind %r — assuming "
            "%.0e FLOP/s; MFU figures from this device are estimates. Pin "
            "the truth with PD_PEAK_FLOPS=<per-device peak> (or extend "
            "PEAK_FLOPS_BY_KIND).", kind, _UNKNOWN_CHIP_GUESS)
    return _UNKNOWN_CHIP_GUESS


def step_flops(fn, *args, **kwargs) -> float:
    """FLOPs of one call ``fn(*args, **kwargs)``: FlopCounterMode's
    count plus the flash-attention kernels' registered FLOPs. The call
    runs (a train step's step is taken)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import flash_attention as _fa
    extra = []
    sink = (lambda f, scope=None: extra.append(f))
    _fa.flop_sinks.append(sink)
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
    finally:
        _fa.flop_sinks.remove(sink)
    total = float(counter.get_total_flops()) + float(sum(extra))
    return total if total > 0 else -1.0


class ThroughputMeter:
    """Per-step examples/sec + MFU accumulator.

        meter = ThroughputMeter(examples_per_step=batch,
                                flops_per_step=step_flops(step, x, y))
        for _ in range(n):
            t0 = time.perf_counter()
            train_step(...)
            meter.step(time.perf_counter() - t0)
        meter.report()   # {'examples_per_sec':..., 'mfu':...}
    """

    def __init__(self, examples_per_step: int,
                 flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 n_devices: Optional[int] = None,
                 name: str = "train"):
        self.examples_per_step = int(examples_per_step)
        self.flops_per_step = flops_per_step
        self.name = name
        if n_devices is None:
            import torch
            n_devices = max(torch.cuda.device_count(), 1) \
                if torch.cuda.is_available() else 1
        if peak_flops is None:
            peak_flops = chip_peak_flops()
        self.peak_flops_total = float(peak_flops) * int(n_devices)
        self.n_devices = int(n_devices)
        self._steps_s = []
        self._t_last = None

    # -- feeding -------------------------------------------------------------
    def step(self, seconds: Optional[float] = None):
        """Record one train step. Pass the measured wall seconds, or
        call with no argument to use the gap since the previous call."""
        now = time.perf_counter()
        if seconds is None:
            seconds = (now - self._t_last) if self._t_last is not None \
                else None
        self._t_last = now
        if seconds is None or seconds <= 0:
            return self
        self._steps_s.append(float(seconds))
        if metrics._enabled:
            metrics.counter("throughput.examples_total").add(
                self.examples_per_step)
            metrics.histogram(f"{self.name}.step_ms").observe(
                seconds * 1e3)
        return self

    # -- reporting -----------------------------------------------------------
    def _median_step(self) -> float:
        if not self._steps_s:
            return -1.0
        ys = sorted(self._steps_s)
        return ys[len(ys) // 2]

    def examples_per_sec(self) -> float:
        med = self._median_step()
        return self.examples_per_step / med if med > 0 else -1.0

    def mfu(self) -> float:
        med = self._median_step()
        if med <= 0 or not self.flops_per_step \
                or self.flops_per_step <= 0:
            return -1.0
        return (self.flops_per_step / med) / self.peak_flops_total

    def report(self) -> dict:
        """Publish gauges and return the rollup dict."""
        eps = self.examples_per_sec()
        mfu = self.mfu()
        metrics.gauge("throughput.examples_per_sec").set(round(eps, 3))
        metrics.gauge("throughput.mfu").set(round(mfu, 6))
        if self.flops_per_step and self.flops_per_step > 0:
            metrics.gauge("throughput.model_flops_per_step").set(
                float(self.flops_per_step))
        return {
            "examples_per_sec": round(eps, 3),
            "mfu": round(mfu, 6),
            "model_flops_per_step": self.flops_per_step,
            "peak_flops_total": self.peak_flops_total,
            "n_devices": self.n_devices,
            "steps": len(self._steps_s),
        }
