"""Memory plane, runtime half (the port's copy of
paddle_tpu/observability/memory.py's live and forensics tiers).

1. **Live tier**: ``sample()`` publishes gated ``memory.*`` gauges, the
   caching allocator's figures per card (``torch.cuda.memory_stats`` and
   ``torch.cuda.mem_get_info``) where CUDA is initialised, and the host
   RSS always.

2. **Forensics tier**: ``handle_dispatch_oom`` sits behind the dispatch
   boundaries the port owns (TrainStep.__call__, the serving engine's
   prefill, decode, draft and verify replays): a caught out-of-memory
   fault (``torch.cuda.OutOfMemoryError``, torch's "CUDA out of memory"
   message, MemoryError) bumps the always-on ``memory.oom_total``
   counter, leaves an ``oom`` flight-recorder breadcrumb (requested,
   free and total bytes parsed from torch's message) and writes a
   post-mortem receipt with the live sample and a remediation hint.

3. **Static tier**: ``train_step_memory`` traces a TrainStep from shapes
   alone (``TrainStep.aot_lower``: a twin of the step on the meta
   device) under a TorchDispatchMode that follows every storage an op
   makes: its bytes, its scope (anatomy.op_scope: the scope open at a
   forward op, the forward's scope for a backward op) and its death (a
   weak reference on the storage). The step's temp peak is the largest
   sum of live storages; each scope gets the bytes it holds live at that
   peak, so the rows sum to the peak. The arguments (parameters,
   buffers, optimizer and strategy state, inputs) are attributed by
   parameter name (sentry.scope_of_param). ``peak_bytes`` = argument
   bytes + the temp peak. The result is registered under its program, so
   an OOM receipt names the top scopes (``top_scope``) and the hint
   reads them.

What the JAX module reads from XLA and the port has no counterpart of:
``memory_analysis_dict`` (a compiled executable's buffer assignment) and
the HLO attribution (``attribute_hlo_memory``, ``attribute_arguments``,
``attribute_compiled_memory``, ``compile_step``); the meta trace above
takes their place, with the live storages where XLA's buffers were.

Cost discipline: the module imports no torch (it reads an
already-imported one from sys.modules); ``sample()`` is one gate read
when telemetry is off; ``handle_dispatch_oom`` lives in an ``except``
clause, zero cost on every dispatch that does not die.
"""
from __future__ import annotations

import json
import os
import re
import sys
import time
from typing import Any, Dict, List, Optional

from . import flight_recorder as _fr
from . import metrics

__all__ = [
    "device_memory_stats", "host_rss_bytes", "sample",
    "is_oom", "parse_oom", "remediation_hint", "oom_postmortem",
    "handle_dispatch_oom", "default_oom_path",
    "train_step_memory", "program_memory", "register_attribution",
    "attribution_of", "publish", "format_table",
]

GIB = float(2 ** 30)


# ---------------------------------------------------------------------------
# live tier: the caching allocator's stats with host-RSS beside them
# ---------------------------------------------------------------------------

def device_memory_stats() -> List[Dict[str, Any]]:
    """Per-card allocator stats from an already-imported torch whose
    CUDA is initialised (it never imports torch nor initialises CUDA
    itself, so it works on a box with no card or a wedged one). Without
    them: [], and callers use the host RSS."""
    torch = sys.modules.get("torch")
    out: List[Dict[str, Any]] = []
    try:
        if torch is None or not torch.cuda.is_initialized():
            return out
        n = torch.cuda.device_count()
    except Exception:
        return out
    for d in range(n):
        try:
            st = torch.cuda.memory_stats(d)
            free, total = torch.cuda.mem_get_info(d)
        except Exception:
            continue
        out.append({
            "device": d,
            "platform": "gpu",
            "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "bytes_limit": int(total),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(st.get("reserved_bytes.all.current", 0)),
            "bytes_free": int(free),
        })
    return out


def host_rss_bytes() -> int:
    """Current resident set of this process (``/proc/self/statm``;
    the ru_maxrss PEAK as a portability fallback)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE")
                                               if hasattr(os, "sysconf")
                                               else 4096)
    except Exception:
        try:
            import resource
            return int(resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss) * 1024
        except Exception:  # pragma: no cover — exotic platform
            return 0


def sample(prefix: str = "memory") -> Optional[dict]:
    """Publish the live occupancy gauges, gated: one bool read and out
    when telemetry is off. Card gauges where CUDA is up,
    ``host_rss_bytes`` always."""
    if not metrics._enabled:
        return None
    devs = device_memory_stats()
    rss = host_rss_bytes()
    for st in devs:
        metrics.gauge(f"{prefix}.device_bytes_in_use",
                      device=st["device"]).set(st["bytes_in_use"])
        if st["bytes_limit"]:
            metrics.gauge(f"{prefix}.device_bytes_limit",
                          device=st["device"]).set(st["bytes_limit"])
        if st["peak_bytes_in_use"]:
            metrics.gauge(f"{prefix}.device_peak_bytes",
                          device=st["device"]).set(
                st["peak_bytes_in_use"])
    metrics.gauge(f"{prefix}.host_rss_bytes").set(rss)
    return {"devices": devs, "host_rss_bytes": rss}


# ---------------------------------------------------------------------------
# forensics tier: the OOM sentry
# ---------------------------------------------------------------------------

_OOM_TOKENS = ("resource_exhausted", "resource exhausted",
               "out of memory", "exceeded hbm capacity")
# "oom" only as a whole word: substring matching would classify any
# message containing "zoom"/"mushroom" as a memory incident, and the
# dispatch sentries see every exception
_OOM_WORD_RE = re.compile(r"\boom\b")

# torch's caching-allocator phrasings:
#   "Tried to allocate 20.00 GiB. GPU 0 has a total capacity of
#    79.11 GiB of which 3.44 GiB is free."
#   (older) "Tried to allocate 2.00 GiB (GPU 0; 15.78 GiB total
#    capacity; 12.00 GiB already allocated; 1.50 GiB free; ...)"
# and the JAX module's generic ones ("allocating 123456 bytes",
# "with 123456 bytes free", "of 15.48G hbm")
_SIZE = r"(\d+(?:\.\d+)?)\s*([KMGT]i?B?)?"
_REQ_RES = (re.compile(r"tried to allocate\s+" + _SIZE, re.I),
            re.compile(r"allocat\w*\s+(?:of\s+)?" + _SIZE, re.I))
_FREE_RES = (re.compile(r"of which\s+" + _SIZE + r"\s+is free", re.I),
             re.compile(_SIZE + r"\s*(?:bytes\s+)?free", re.I))
_LIMIT_RES = (re.compile(r"total capacity of\s+" + _SIZE, re.I),
              re.compile(_SIZE + r"\s+total capacity", re.I),
              re.compile(r"of\s+" + _SIZE + r"\s*(?:hbm|memory)", re.I))
_UNIT = {None: 1, "": 1, "B": 1,
         # bare K/M/G/T mean binary; explicit KB/MB/... stay decimal,
         # KiB/MiB/... binary
         "K": 1024, "KB": 1000, "KiB": 1024,
         "M": 1024 ** 2, "MB": 1000 ** 2, "MiB": 1024 ** 2,
         "G": 1024 ** 3, "GB": 1000 ** 3, "GiB": 1024 ** 3,
         "T": 1024 ** 4, "TB": 1000 ** 4, "TiB": 1024 ** 4}
_UNIT_CI = {(k or "").upper(): v for k, v in _UNIT.items()}


def is_oom(exc: BaseException) -> bool:
    """Is this exception an out-of-memory fault? Python's MemoryError
    (the paged cache's exhaustion contract), torch's
    ``torch.cuda.OutOfMemoryError``, or a message that says so ("CUDA
    out of memory", RESOURCE_EXHAUSTED)."""
    if isinstance(exc, MemoryError):
        return True
    torch = sys.modules.get("torch")
    oom_cls = getattr(getattr(torch, "cuda", None), "OutOfMemoryError",
                      None)
    if oom_cls is not None and isinstance(exc, oom_cls):
        return True
    msg = f"{type(exc).__name__}: {exc}".lower()
    return (any(tok in msg for tok in _OOM_TOKENS)
            or _OOM_WORD_RE.search(msg) is not None)


def _to_bytes(num: str, unit: Optional[str]) -> int:
    u = (unit or "").strip().upper()
    return int(float(num) * _UNIT_CI.get(u, 1))


def _first(res, message):
    for r in res:
        m = r.search(message)
        if m:
            return _to_bytes(m.group(1), m.group(2))
    return None


def parse_oom(message: str) -> Dict[str, Optional[int]]:
    """Best-effort requested/free/limit bytes from an OOM message
    (None where the phrasing carries no figure)."""
    return {"requested_bytes": _first(_REQ_RES, message),
            "free_bytes": _first(_FREE_RES, message),
            "limit_bytes": _first(_LIMIT_RES, message)}


def remediation_hint(program: str, top_scope: Optional[str]) -> str:
    """The runbook's first move, named in the receipt: head-heavy steps
    stream the CE, activation-heavy steps remat or shrink the batch,
    serving shrinks its static shapes."""
    p = str(program)
    if p.startswith("serving"):
        return ("shrink the serving shapes: fewer n_blocks / smaller "
                "prefill bucket / lower max_admit (admission control "
                "is the only other backpressure)")
    if top_scope == "mlm_head_ce":
        return ("enable chunked_ce (stream the MLM head + CE through "
                "vocab blocks — the [b*s, vocab] logits never "
                "materialize)")
    if top_scope in ("attn", "mlp", "embed"):
        return ("enable remat=True (recompute activations in the "
                "backward) or shrink the per-chip batch")
    return "shrink the per-chip batch or raise grad_accum_steps"


def default_oom_path(program: str) -> str:
    """Receipt path next to the flight-recorder dumps ($PD_OOM_DIR, else
    the recorder's directory; ``oom_<program>_rank<r>_pid<p>.json``)."""
    d = os.environ.get("PD_OOM_DIR") or _fr.default_dir()
    safe = "".join(c if c.isalnum() or c in "_.-" else "_"
                   for c in str(program)) or "program"
    return os.path.join(
        d, f"oom_{safe}_rank{_fr._rank()}_pid{os.getpid()}.json")


def oom_postmortem(program: str, exc: BaseException, top_k: int = 5,
                   **context) -> dict:
    """The post-mortem receipt: program, requested vs free, the live
    memory sample, the top-k scopes of the program's last registered
    static attribution (``top_scope``: the largest that is not
    ``unattributed``; None without one) and the remediation hint."""
    msg = f"{type(exc).__name__}: {exc}"
    doc: Dict[str, Any] = {
        "version": 1,
        "program": str(program),
        "ts": time.time(),
        "rank": _fr._rank(),
        "error": msg[:1000],
    }
    doc.update(parse_oom(msg))
    doc.update({k: v for k, v in context.items() if v is not None})
    doc["devices"] = device_memory_stats()
    doc["host_rss_bytes"] = host_rss_bytes()
    top_scope = None
    att = attribution_of(program)
    if att is not None:
        rows = list(att.get("scopes", {}).items())[:top_k]
        doc["top_scopes"] = [
            {"scope": n, "bytes": r["bytes"],
             "share": round(r["share"], 4)} for n, r in rows]
        non_stray = [n for n, _ in rows if n != "unattributed"]
        top_scope = non_stray[0] if non_stray else None
        doc["peak_bytes_static"] = att.get("peak_bytes")
    doc["top_scope"] = top_scope
    doc["hint"] = remediation_hint(program, top_scope)
    return doc


def handle_dispatch_oom(program: str, exc: BaseException,
                        receipt_path: Optional[str] = None,
                        **context) -> Optional[dict]:
    """The dispatch-boundary sentry: call from an ``except`` clause
    around a captured-program dispatch and re-raise after. Not an OOM:
    None, nothing recorded. An OOM: the always-on counter, the
    flight-recorder ``oom`` breadcrumb and the post-mortem receipt
    written next to the flight dumps. Never raises itself: forensics
    must not mask the original fault."""
    if not is_oom(exc):
        return None
    try:
        doc = oom_postmortem(program, exc, **context)
    except Exception:  # pragma: no cover — forensics must not mask
        doc = {"program": str(program), "error": str(exc)[:300],
               "hint": remediation_hint(program, None)}
    # always-on: an OOM is an incident whether or not anyone armed
    # telemetry (the recompile-sentinel contract)
    metrics.counter("memory.oom_total", _always=True,
                    program=str(program)).add(1)
    _fr.record("oom", program=str(program),
               requested_bytes=doc.get("requested_bytes"),
               free_bytes=doc.get("free_bytes"),
               top_scope=doc.get("top_scope"),
               hint=doc.get("hint"),
               error=str(exc)[:300],
               **{k: v for k, v in context.items()
                  if isinstance(v, (int, float, str, bool))})
    path = receipt_path or default_oom_path(program)
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)),
                    exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, default=str)
        os.replace(tmp, path)
        doc["receipt_path"] = path
    except Exception:  # pragma: no cover — disk full IS the incident
        pass
    return doc


# ---------------------------------------------------------------------------
# static tier: the step traced from shapes alone
# ---------------------------------------------------------------------------

def _storage_key(t):
    st = t.untyped_storage()
    return st._cdata, st


class _LiveBytes:
    """The storages a traced run makes, live and at the peak, by scope."""

    def __init__(self, held):
        self.held = set(held)          # argument storages: not temps
        self.live: Dict[int, tuple] = {}
        self.by_scope: Dict[str, float] = {}
        self.count: Dict[str, int] = {}
        self.total = 0.0
        self.peak = 0.0
        self.at_peak: Dict[str, float] = {}
        self.count_at_peak: Dict[str, int] = {}
        self._refs = []

    def made(self, t, scope_name):
        import weakref
        key, st = _storage_key(t)
        if key in self.held or key in self.live:
            return
        nbytes = float(st.nbytes())
        self.live[key] = (nbytes, scope_name)
        self.total += nbytes
        self.by_scope[scope_name] = self.by_scope.get(scope_name, 0.0) \
            + nbytes
        self.count[scope_name] = self.count.get(scope_name, 0) + 1
        self._refs.append(weakref.ref(st, lambda _r, k=key: self.died(k)))
        if self.total > self.peak:
            self.peak = self.total
            self.at_peak = dict(self.by_scope)
            self.count_at_peak = dict(self.count)

    def died(self, key):
        got = self.live.pop(key, None)
        if got is None:
            return
        nbytes, scope_name = got
        self.total -= nbytes
        self.by_scope[scope_name] -= nbytes
        self.count[scope_name] -= 1


def _traced_peak(lowered):
    """(arguments table, _LiveBytes) of one run of a lowered step under
    the storage-following dispatch mode, the scopes read as
    anatomy.count_flops reads them."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from . import anatomy
    from .sentry import scope_of_param

    args = lowered.arguments()
    per: Dict[str, float] = {}
    held = set()
    total = 0.0
    for name, t in args.items():
        key, st = _storage_key(t)
        if key in held:
            continue
        held.add(key)
        # an optimizer state's name is "<param>/<key>"; a strategy
        # entry's "strategy/<key>": both by their parameter's scope
        sc = scope_of_param(name)
        per[sc] = per.get(sc, 0.0) + float(st.nbytes())
        total += float(st.nbytes())
    arguments = {
        "scopes": {k: {"bytes": v, "share": (v / total) if total else 0.0,
                       "donated_bytes": 0.0}
                   for k, v in sorted(per.items(), key=lambda kv: -kv[1])},
        "total_bytes": total,
    }
    live = _LiveBytes(held)

    class _Follow(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            sc = anatomy.op_scope()
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    live.made(t, sc)
            return out

    from ..ops import flash_attention as _fa
    # a silent listener: flash attention's plain versions (the CPU) then
    # run unseen, as a kernel's work is, and only its outputs count
    quiet = (lambda flops, scope=None: None)
    _fa.flop_sinks.append(quiet)
    try:
        with anatomy.tag_scopes(), _Follow():
            lowered.run()
    finally:
        _fa.flop_sinks.remove(quiet)
    return arguments, live


def train_step_memory(step, inputs, labels=(), *,
                      publish_gauges: bool = False,
                      program: str = "train_step", lowered=None) -> dict:
    """Per-scope memory table of a TrainStep's step, from shapes alone
    (step.aot_lower, unless ``lowered`` is given): the bytes each scope
    holds live at the step's temp peak (shares sum to 1.0, an
    ``unattributed`` row for ops outside any scope), the arguments by
    parameter scope, and ``peak_bytes`` = arguments + temp peak. The
    result is registered under ``program`` for the OOM receipt."""
    if lowered is None:
        lowered = step.aot_lower(inputs, labels)
    return program_memory(program, lowered, publish_gauges=publish_gauges)


def program_memory(program: str, lowered, *,
                   publish_gauges: bool = False) -> dict:
    """Generic program entry: a lowered program (run() and arguments(),
    as TrainStep.aot_lower gives) traced, attributed and registered
    under ``program``."""
    arguments, live = _traced_peak(lowered)
    peak = live.peak
    rows = {name: {"bytes": b, "share": (b / peak) if peak else 0.0,
                   "ops": int(live.count_at_peak.get(name, 0))}
            for name, b in live.at_peak.items() if b > 0}
    arg_bytes = arguments["total_bytes"]
    out = {
        "scopes": dict(sorted(rows.items(), key=lambda kv: -kv[1]["bytes"])),
        "total_bytes": peak,
        "unattributed_share": rows.get("unattributed", {}).get("share",
                                                              0.0),
        "memory": {"argument_bytes": arg_bytes, "output_bytes": 0.0,
                   "temp_bytes": peak, "peak_bytes": arg_bytes + peak,
                   "peak_is_exact": False},
        "peak_bytes": arg_bytes + peak,
        "arguments": arguments,
    }
    register_attribution(program, out)
    if publish_gauges:
        publish(out, program=program)
    return out


# the last static attribution per program: the OOM receipt's evidence
_ATTRIBUTIONS: Dict[str, dict] = {}


def register_attribution(program: str, result: dict) -> dict:
    _ATTRIBUTIONS[str(program)] = result
    return result


def attribution_of(program: str) -> Optional[dict]:
    return _ATTRIBUTIONS.get(str(program))


def publish(result: dict, program: str = "train_step",
            prefix: str = "memory"):
    """Route a memory table through the metrics runtime, always-on:
    ``memory.temp_share{scope=,program=}`` gauges plus the per-program
    totals."""
    for name, row in result.get("scopes", {}).items():
        metrics.gauge(f"{prefix}.temp_share", _always=True,
                      program=program,
                      scope=name).set(round(row["share"], 6))
    ma = result.get("memory") or {}
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "peak_bytes"):
        if key in ma:
            metrics.gauge(f"{prefix}.{key}", _always=True,
                          program=program).set(ma[key])
    return result


def format_table(result: dict, title: str = "memory anatomy") -> str:
    """Human-readable memory share table."""
    ma = result.get("memory") or {}
    lines = [
        f"{title}: peak {ma.get('peak_bytes', 0) / GIB:.4f} GiB "
        f"(arg {ma.get('argument_bytes', 0) / GIB:.4f}, "
        f"temp {ma.get('temp_bytes', 0) / GIB:.4f}, "
        f"out {ma.get('output_bytes', 0) / GIB:.4f}"
        + ("" if ma.get("peak_is_exact") else "; peak reconstructed")
        + ")"]
    lines.append(f"  {'scope':<14} {'share':>7} {'mbytes':>10} "
                 f"{'ops':>5}")
    for name, row in result.get("scopes", {}).items():
        lines.append(
            f"  {name:<14} {row['share']:>6.1%} "
            f"{row['bytes'] / 1e6:>10.2f} {row['ops']:>5}")
    args = result.get("arguments")
    if args:
        lines.append(f"  arguments ({args['total_bytes'] / 1e6:.2f} MB "
                     "by param scope):")
        for name, row in args["scopes"].items():
            lines.append(
                f"    {name:<12} {row['share']:>6.1%} "
                f"{row['bytes'] / 1e6:>10.2f} MB "
                f"(donated {row['donated_bytes'] / 1e6:.2f})")
    return "\n".join(lines)
