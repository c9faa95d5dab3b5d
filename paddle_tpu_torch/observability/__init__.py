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
  memory           the runtime half: the caching allocator's gauges and
                   the OOM sentry at the dispatch boundaries
  reqtrace         per-request span timelines, explain_tail, chrome-trace
                   request lanes, the SLO BurnMeter
  timeseries       the pulse: sampled rings of the registry
  pulse_server     the localhost /metrics, /healthz, /snapshot, /series
                   HTTP thread
  decisions        the control-plane decision ledger
  fleet            metric rollups across processes (all_gather_object
                   over a process group) and the skip-and-flag merge of
                   the serving fleet's replicas

Everything but the decision ledger is off by default:
`metrics.enable()` turns the counter hot paths on,
`flight_recorder.enable()` arms the forensics plane (events + goodput),
`reqtrace.enable()` the request spans. No plane but the sentinel
imports torch (memory reads an already-imported one), so a dump works
while the card is wedged. Left out: the static planes (`anatomy`,
`calibration`, `xprof`, `mfu`, `sentry`, and memory's HLO tier;
ROADMAP.md queue A item 17).
"""
from . import metrics  # noqa: F401
from . import decisions  # noqa: F401
from . import fleet  # noqa: F401
from . import exporters  # noqa: F401
from . import goodput  # noqa: F401
from . import flight_recorder  # noqa: F401
from . import memory  # noqa: F401
from . import pulse_server  # noqa: F401
from . import reqtrace  # noqa: F401
from . import timeseries  # noqa: F401
from . import sentinel  # noqa: F401
from . import watchdog  # noqa: F401
from .metrics import (counter, gauge, histogram, enable, disable,  # noqa: F401
                      enabled, enabled_scope, snapshot, reset)
from .sentinel import (RecompileSentinel, count_capture,  # noqa: F401
                       diff_signatures, signature_of)
from .watchdog import HangWatchdog  # noqa: F401

__all__ = [
    "metrics", "exporters", "sentinel", "flight_recorder", "watchdog",
    "goodput", "memory", "reqtrace", "timeseries", "pulse_server",
    "decisions", "fleet",
    "counter", "gauge", "histogram", "enable", "disable", "enabled",
    "enabled_scope", "snapshot", "reset",
    "RecompileSentinel", "signature_of", "diff_signatures",
    "count_capture", "HangWatchdog",
]
