"""Step anatomy: scope attribution inside the captured train step
(counterpart of paddle_tpu/observability/anatomy.py, the same taxonomy,
names and table shapes).

1. **Scopes**: ``scope("attn")`` is a ``torch.profiler.record_function``
   range plus an NVTX range, and a frame on this thread's scope stack
   (``current_scope``) that the FLOP count below and memory's static
   half read. The first entry of each name leaves a ``scope`` breadcrumb
   when the flight recorder is armed. The port's modules open the JAX
   package's scopes at the JAX sites (models/ernie.py, the serving
   programs, the pipeline engine, TrainStep's loss_scale and optimizer,
   distributed/comm.py's grad_sync).

2. **FLOPs by scope** (``train_step_anatomy``): one eager step of the
   TrainStep under ``count_flops``, which counts every op of
   ``torch.utils.flop_counter``'s formula table (the matmuls and
   convolutions) plus the flash-attention kernels' registered FLOPs
   (ops/flash_attention.py: 4 b n sq sk h forward, 2.5 times that
   backward, halved when causal), each under its scope: a forward op
   under the innermost scope open at the call, a backward op under the
   scope of the forward op whose autograd node runs it (the nodes are
   tagged at the forward). Shares sum to 1.0 with an ``unattributed``
   row. A graph replay carries no record_function ranges and passes
   through no Python, so the scopes are read from an eager step that
   launches the same kernels; the table says so (``source``).
   Device milliseconds by scope come from a profiled step through
   ``xprof.attribute_device_time`` (``device_ms``).

What the JAX module reads from XLA and the port has no counterpart of:
``attribute_hlo_text``, ``attribute_compiled`` and ``compile_uncached``
price an executable's HLO text; a CUDA graph has none, and the eager
step's dispatched ops take their place.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Dict, Iterable, Optional, Set

from . import flight_recorder as _fr
from . import metrics

__all__ = [
    "scope", "known_scopes", "register_scope", "CORE_SCOPES",
    "scope_of_op_name", "current_scope", "op_scope", "tag_scopes",
    "count_flops",
    "train_step_anatomy", "publish", "format_table",
]

# The step taxonomy every attribution surface shares (this module,
# xprof's device tier, memory's static half, the sentry's rows): the
# named pieces of one ERNIE-class train step. scope() registers any
# further name on first use.
CORE_SCOPES = (
    "embed",        # token/position/type embeddings + their norm
    "attn",         # qkv/proj matmuls, SDPA/flash, residual + norm
    "mlp",          # ffn matmuls (or MoE experts), residual + norm
    "mlm_head_ce",  # mlm transform + tied-decoder logits + softmax-CE
    "loss_scale",   # amp scale/unscale, finite check, skip-step select
    "optimizer",    # the update rule (AdamW etc.)
    "grad_sync",    # comm.py fused-bucket gradient collectives
    "pp_ring",      # pipeline ppermute activation/grad transfers
)

_SCOPES: Set[str] = set(CORE_SCOPES)
_BREADCRUMBED: Set[str] = set()
_tls = threading.local()

#: where the eager step's scopes stand in for a replay's (the table's
#: ``source``)
EAGER_SOURCE = ("one eager step of the TrainStep (a CUDA-graph replay "
                "carries no record_function ranges; the eager step "
                "launches the same kernels)")


def register_scope(name: str) -> str:
    """Add a name to the attribution taxonomy (scope() does this
    automatically)."""
    if not name or "/" in name:
        raise ValueError(f"scope name {name!r}: non-empty, no '/'")
    _SCOPES.add(name)
    return name


def known_scopes() -> Set[str]:
    """The registered taxonomy (a copy)."""
    return set(_SCOPES)


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_scope() -> Optional[str]:
    """The innermost scope open on this thread (None outside any)."""
    st = _stack()
    return st[-1] if st else None


@contextlib.contextmanager
def scope(name: str):
    """Annotate everything run inside with `name`: a
    torch.profiler.record_function range (its events carry the name in
    a trace), an NVTX range on the card, and a frame of the scope stack.
    Registers the name and, when the flight recorder is armed, records a
    one-time ``scope`` breadcrumb."""
    import torch
    _SCOPES.add(name)
    if _fr.enabled() and name not in _BREADCRUMBED:
        _BREADCRUMBED.add(name)
        _fr.record("scope", name=name)
    st = _stack()
    st.append(name)
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        st.pop()


# ---------------------------------------------------------------------------
# scope extraction from op paths (trace events, HLO-style op names)
# ---------------------------------------------------------------------------

_TOKEN_SPLIT = re.compile(r"[()\[\]{} ]+")


def scope_of_op_name(op_name: str,
                     scopes: Optional[Iterable[str]] = None
                     ) -> Optional[str]:
    """Innermost registered scope in an op path such as
    ``jit(step)/transpose(jvp(attn))/mlp/dot`` (components are scope
    frames, possibly wrapped by transform frames). The deepest component
    holding a registered scope token wins."""
    want = _SCOPES if scopes is None else set(scopes)
    for comp in reversed(op_name.split("/")):
        toks = [t for t in _TOKEN_SPLIT.split(comp) if t]
        for tok in reversed(toks):
            if tok in want:
                return tok
    return None


# ---------------------------------------------------------------------------
# FLOPs by scope over an eager run
# ---------------------------------------------------------------------------

_UNATTRIBUTED = "unattributed"
_SCOPE_KEY = "pd_scope"


def op_scope() -> str:
    """The scope an op dispatched now belongs to: the innermost open
    scope in a forward; in a backward, the scope its autograd node was
    tagged with at the forward (count_flops' tagging); else
    ``unattributed``."""
    import torch
    node = torch._C._current_autograd_node()
    if node is not None:
        return node.metadata.get(_SCOPE_KEY) or _UNATTRIBUTED
    return current_scope() or _UNATTRIBUTED


class _Counts:
    """The per-scope table one count_flops run fills."""

    def __init__(self):
        self.flops: Dict[str, float] = {}
        self.ops: Dict[str, int] = {}

    def add(self, scope_name, flops):
        self.flops[scope_name] = self.flops.get(scope_name, 0.0) + flops
        self.ops[scope_name] = self.ops.get(scope_name, 0) + 1

    @property
    def total(self) -> float:
        return float(sum(self.flops.values()))


def _tag_outputs(out, scope_name):
    """Tag the autograd nodes an op made with its scope: its outputs'
    nodes and the nodes behind them that no earlier op tagged (a
    function built of several ops in C++, cross_entropy's log_softmax,
    autocast's casts, makes nodes the function mode never sees)."""
    import torch
    if isinstance(out, torch.Tensor):
        stack = [out.grad_fn]
    elif isinstance(out, (list, tuple)):
        stack = [o.grad_fn for o in out if isinstance(o, torch.Tensor)]
    else:
        return
    while stack:
        fn = stack.pop()
        if fn is None or _SCOPE_KEY in fn.metadata:
            continue
        fn.metadata[_SCOPE_KEY] = scope_name
        stack.extend(nxt for nxt, _ in fn.next_functions)


def tag_scopes():
    """A TorchFunctionMode that tags the autograd nodes every op makes
    with the scope open at the call (node.metadata; ``unattributed``
    outside every scope), so op_scope finds it when the backward runs
    the node."""
    import torch
    from torch.overrides import TorchFunctionMode

    class _Tag(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if torch.is_grad_enabled():
                # an op outside every scope tags its nodes too, so a
                # later scoped op's walk stops at them
                _tag_outputs(out, current_scope() or _UNATTRIBUTED)
            return out
    return _Tag()


@contextlib.contextmanager
def count_flops(ranges: bool = False):
    """Count the FLOPs of everything run inside, by scope: the ops of
    torch.utils.flop_counter's formula table and the flash-attention
    kernels' registered FLOPs (whose plain versions are not counted
    again). Yields the table (``.flops``, ``.ops``, ``.total``), filled
    when the block ends. With ``ranges`` every backward op also runs in
    a record_function range named by its scope, so a profiler sees the
    backward's kernels under the forward's scopes."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    from ..ops import flash_attention as _fa

    counts = _Counts()

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            sc = op_scope()
            if ranges and torch._C._current_autograd_node() is not None:
                with torch.profiler.record_function(sc):
                    out = func(*args, **kwargs)
            else:
                out = func(*args, **kwargs)
            rule = flop_registry.get(func._overloadpacket)
            if rule is not None:
                counts.add(sc, float(rule(*args, **kwargs, out_val=out)))
            return out

    def flash(flops, backward_scope=None):
        counts.add(backward_scope or op_scope(), float(flops))

    _fa.flop_sinks.append(flash)
    try:
        with tag_scopes(), _Count():
            yield counts
    finally:
        _fa.flop_sinks.remove(flash)


def table(counts: _Counts) -> dict:
    """count_flops' table as the JAX module's result: {"scopes": {name:
    {flops, share, ops}}, "total_flops", "unattributed_share"}, shares
    over the counted total (they sum to 1.0)."""
    total = counts.total
    rows = {name: {"flops": f, "share": (f / total) if total else 0.0,
                   "bytes": 0.0, "ops": int(counts.ops.get(name, 0))}
            for name, f in counts.flops.items()}
    return {
        "scopes": dict(sorted(rows.items(), key=lambda kv: -kv[1]["flops"])),
        "total_flops": total,
        "unattributed_share": rows.get(_UNATTRIBUTED, {}).get("share", 0.0),
    }


def train_step_anatomy(step, inputs, labels=(), *,
                       publish_gauges: bool = False, seed: int = 0,
                       profile: bool = False) -> dict:
    """Per-scope FLOP share table of a TrainStep's step: one eager step
    (step.eager_step, the body a replay runs) under count_flops. It is a
    real step: the parameters move as a training step moves them. With
    ``profile`` the step runs under torch.profiler too (every backward
    op in a range named by its scope), and ``device_ms`` holds
    xprof.attribute_device_time of its device events (per-scope device
    ms, busy, idle) and ``profiler_device_ms``, the same trace's device
    total from torch.profiler's event list. ``source`` names where the
    scopes come from."""
    prof = None
    with contextlib.ExitStack() as stack:
        if profile:
            prof = stack.enter_context(_profiler())
        with count_flops(ranges=profile) as counts:
            step.eager_step(inputs, labels, seed=seed)
        if prof is not None:
            import torch
            torch.cuda.synchronize()
    out = table(counts)
    out["source"] = EAGER_SOURCE
    if prof is not None:
        from . import xprof
        out["device_ms"] = xprof.attribute_device_time(
            xprof.events_of(prof))
        # the same trace's device total as torch's own event list counts
        # it, the cross-check of the parse
        out["device_ms"]["profiler_device_ms"] = sum(
            ev.time_range.elapsed_us() for ev in prof.events()
            if str(getattr(ev, "device_type", "")).endswith("CUDA")
            and not getattr(ev, "is_user_annotation", False)) / 1e3
    if publish_gauges:
        publish(out)
    return out


def _profiler():
    import torch
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def publish(result: dict, prefix: str = "anatomy"):
    """Route a share table through the metrics runtime:
    ``anatomy.flops_share{scope=}`` gauges + totals, always-on."""
    for name, row in result.get("scopes", {}).items():
        metrics.gauge(f"{prefix}.flops_share", _always=True,
                      scope=name).set(round(row["share"], 6))
    metrics.gauge(f"{prefix}.total_flops", _always=True).set(
        result.get("total_flops", -1.0))
    ca = result.get("cost_analysis_flops")
    if ca is not None:
        metrics.gauge(f"{prefix}.cost_analysis_flops",
                      _always=True).set(ca)
    return result


def format_table(result: dict, title: str = "step anatomy") -> str:
    """Human-readable share table."""
    lines = [f"{title}: {result.get('total_flops', 0):.3e} FLOPs "
             f"(cost_analysis: {result.get('cost_analysis_flops', -1):.3e})"]
    lines.append(f"  {'scope':<14} {'share':>7} {'gflops':>10} "
                 f"{'mbytes':>9} {'ops':>5}")
    for name, row in result.get("scopes", {}).items():
        lines.append(
            f"  {name:<14} {row['share']:>6.1%} "
            f"{row['flops'] / 1e9:>10.3f} {row['bytes'] / 1e6:>9.2f} "
            f"{row['ops']:>5}")
    return "\n".join(lines)
