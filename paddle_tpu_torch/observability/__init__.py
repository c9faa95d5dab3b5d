"""paddle_tpu_torch.observability: the telemetry planes (counterpart of
paddle_tpu/observability, the same public names, metric names, event
names and JSON shapes, so dumps and dashboards read alike).

  metrics          counters/gauges/histograms, thread-sharded, one-bool
                   disabled gate
  sentinel         RecompileSentinel (the program-count guard of the
                   engine, the TrainStep and generate) and the CUDA-graph
                   capture odometer (cuda_graph.captures_total)
  exporters        Prometheus text, JSONL time series, chrome-trace
                   counter marks, the bench-report bridge
  flight_recorder  the black box: a ring of structured events, dumped on
                   demand, on crash and on SIGTERM/SIGQUIT
  watchdog         HangWatchdog on the flight recorder's step clock
  goodput          wall-clock buckets: train, compile (captures),
                   checkpoint, dataloader, stalled, other
  memory           the caching allocator's gauges, the OOM sentry at the
                   dispatch boundaries, and the static half: per-scope
                   bytes live at a step's peak from a meta-device trace
                   (TrainStep.aot_lower), which the OOM receipt's
                   top_scope reads
  reqtrace         per-request span timelines, explain_tail, chrome-trace
                   request lanes, the SLO BurnMeter
  timeseries       the pulse: sampled rings of the registry
  pulse_server     the localhost /metrics, /healthz, /snapshot, /series
                   HTTP thread
  decisions        the control-plane decision ledger
  fleet            metric rollups across processes (all_gather_object
                   over a process group) and the skip-and-flag merge of
                   the serving fleet's replicas
  anatomy          scope("attn") ranges (record_function + NVTX + a scope
                   stack) and the per-scope FLOP table of a TrainStep's
                   step
  xprof            the measured tier: a torch.profiler trace's device
                   events by scope, idle time, the comm-overlap receipt
  mfu              ThroughputMeter, the card's peak, FlopCounterMode FLOPs
  sentry           numeric integrity: in-graph per-scope grad/param stats
                   and every-K fingerprints in the captured step, the
                   z-score monitor, fingerprint agreement, health stamps,
                   fault captures
  calibration      the probes' table, Calibration, the planner's
                   calibrated prediction and the audit loop

Everything but the decision ledger is off by default:
`metrics.enable()` turns the counter hot paths on,
`flight_recorder.enable()` arms the forensics plane (events + goodput),
`reqtrace.enable()` the request spans. No plane but the sentinel
imports torch at import (the others read or import it when called), so a
dump works while the card is wedged. What the JAX planes read from XLA's
HLO and cost analysis has no counterpart in a CUDA graph; each module
names what replaces it.
"""
from . import metrics  # noqa: F401
from . import anatomy  # noqa: F401
from . import calibration  # noqa: F401
from . import decisions  # noqa: F401
from . import fleet  # noqa: F401
from . import exporters  # noqa: F401
from . import goodput  # noqa: F401
from . import flight_recorder  # noqa: F401
from . import memory  # noqa: F401
from . import mfu  # noqa: F401
from . import pulse_server  # noqa: F401
from . import reqtrace  # noqa: F401
from . import sentry  # noqa: F401
from . import timeseries  # noqa: F401
from . import sentinel  # noqa: F401
from . import watchdog  # noqa: F401
from . import xprof  # noqa: F401
from .anatomy import scope  # noqa: F401
from .metrics import (counter, gauge, histogram, enable, disable,  # noqa: F401
                      enabled, enabled_scope, snapshot, reset)
from .mfu import ThroughputMeter, chip_peak_flops, step_flops  # noqa: F401
from .sentinel import (RecompileSentinel, count_capture,  # noqa: F401
                       diff_signatures, signature_of)
from .watchdog import HangWatchdog  # noqa: F401

__all__ = [
    "metrics", "exporters", "fleet", "mfu", "sentinel",
    "flight_recorder", "watchdog", "goodput", "anatomy", "xprof",
    "memory", "reqtrace", "sentry", "timeseries", "pulse_server",
    "calibration", "decisions",
    "counter", "gauge", "histogram", "enable", "disable", "enabled",
    "enabled_scope", "snapshot", "reset", "scope",
    "ThroughputMeter", "chip_peak_flops", "step_flops",
    "RecompileSentinel", "signature_of", "diff_signatures",
    "count_capture", "HangWatchdog",
]
