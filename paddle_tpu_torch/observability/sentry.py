"""Numeric integrity sentry: in-graph SDC detection for the captured step
(counterpart of paddle_tpu/observability/sentry.py, the same names,
rows, events and stamps).

1. **In-graph statistics** (``stats_by_scope``): per-scope nonfinite
   counts, max-abs and L2 norms over the gradient and parameter trees,
   torch ops on the card that are safe under a CUDA-graph capture (no
   host read), computed inside the captured TrainStep. The leaves of
   one scope and dtype are flattened into one buffer first, so a scope
   costs a handful of kernels whatever its leaf count. NaNs are zeroed
   in the magnitude streams (the nonfinite counter carries them). Scopes
   reuse anatomy.CORE_SCOPES through a param-name token map
   (``scope_of_param``), so the rows line up with the anatomy plane's.

2. **Cross-replica agreement probe** (``fingerprint_tree``): an
   order-sensitive uint32 fingerprint of the parameters' bits, the JAX
   module's to the bit: each leaf is viewed as integers (``Tensor.view``:
   float32 as int32, 2-byte floats as int16, 1-byte as int8) and masked
   into int64 lanes, summed in int64 (110 M terms below 2**32 stay below
   2**63) and reduced ``& 0xFFFFFFFF``, which equals the uint32
   wraparound sum; the leaves combine as ``fp = fp * 1000003 + sum``
   modulo 2**32 in name order. ``host_fingerprint`` is the numpy twin.

3. **Host-side spike detection** (``SentryMonitor``): the rolling
   z-score detector over every stat stream, ``sentry.anomaly``
   flight-recorder events, the always-on ``sentry.anomalies_total``
   counter, gated ``sentry.*`` gauges, cross-replica
   ``judge_fingerprints`` and the checkpoint **health stamp**.

4. **Fault captures** (``write_fault_capture``/``load_fault_capture``):
   params, batch, rng and the observed stats in an npz, for a replay
   that tells a reproducible fault from a transient one.

``NumericSentry`` is the object ``TrainStep(sentry=)`` takes: its
``init_state`` puts the step counter and the fingerprint in
strategy_state as card tensors, ``instrument`` computes the statistics
inside the step (from the pre-sync gradients and the new parameters)
and picks a fresh fingerprint every ``fingerprint_every`` steps with
torch.where, as the JAX code's lax.cond does (the fingerprint is
computed every step and selected), and ``consume`` reads every scalar
after the step in ONE device-to-host copy of a packed float64 tensor
(every value is exact in float64: counts, float32 magnitudes, uint32
fingerprints). Everything is opt-in: a TrainStep without ``sentry=``
runs the same program as before, and with it the parameters after N
steps are bit-equal to those without it (the sentry only reads).
torch is imported lazily, so the host-side monitor works where torch
is absent or the card is wedged.
"""
from __future__ import annotations

import collections
import math
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from . import flight_recorder as _fr
from . import metrics as _obs

__all__ = [
    "SentryConfig", "NumericSentry", "SentryMonitor", "NumericFault",
    "scope_of_param", "stats_by_scope", "fingerprint_tree",
    "host_fingerprint", "host_stats_by_scope",
    "write_fault_capture", "load_fault_capture",
]


# -- scope mapping ------------------------------------------------------------

# param-name tokens -> anatomy.CORE_SCOPES buckets (first hit wins:
# specific head/embedding tokens before the generic attn/mlp ones).
# Unmatched names fall into "other" so the table partitions the tree.
_SCOPE_TOKENS: Tuple[Tuple[str, str], ...] = (
    ("embed", "embed"), ("embedding", "embed"), ("pos_", "embed"),
    ("mlm", "mlm_head_ce"), ("lm_head", "mlm_head_ce"),
    ("decoder", "mlm_head_ce"), ("cls", "mlm_head_ce"),
    ("attn", "attn"), ("attention", "attn"), ("q_proj", "attn"),
    ("k_proj", "attn"), ("v_proj", "attn"), ("qkv", "attn"),
    ("out_proj", "attn"),
    ("mlp", "mlp"), ("ffn", "mlp"), ("fc", "mlp"), ("linear", "mlp"),
    ("expert", "mlp"),
)


def scope_of_param(name: str) -> str:
    """Map a param name onto the anatomy taxonomy (CORE_SCOPES) by
    name tokens; unmatched names bucket under "other"."""
    low = name.lower()
    for token, scope in _SCOPE_TOKENS:
        if token in low:
            return scope
    return "other"


# -- in-graph statistics ------------------------------------------------------

def _counted(leaf) -> bool:
    """Whether a leaf enters the statistics: a floating leaf that is not
    bfloat16. The JAX module tests np.issubdtype(dtype, np.inexact),
    which bfloat16 (an ml_dtypes type) fails, so its statistics skip
    bfloat16 leaves; the port skips them too (ROADMAP.md's reference
    quirks). The fingerprint covers every leaf."""
    import torch
    return leaf.is_floating_point() and leaf.dtype != torch.bfloat16


def _groups(tree, scope_fn):
    """{scope: {dtype: [counted leaves]}} in name order (_counted; empty
    leaves skipped)."""
    groups: Dict[str, Dict[Any, list]] = {}
    for name in sorted(tree):
        leaf = tree[name]
        if not _counted(leaf) or leaf.numel() == 0:
            continue
        groups.setdefault(scope_fn(name), {}).setdefault(
            leaf.dtype, []).append(leaf.detach().reshape(-1))
    return groups


def stats_by_scope(tree: Mapping[str, Any],
                   scope_fn=scope_of_param) -> Dict[str, Dict[str, Any]]:
    """Per-scope {nonfinite (int32), max_abs (f32), l2 (f32)} over a flat
    name -> tensor dict, as 0-d tensors on the leaves' device: no host
    read, so it runs inside a captured step. Leaves that are not
    floating, or are bfloat16, are skipped (_counted)."""
    import torch
    out: Dict[str, Dict[str, Any]] = {}
    for scope_name, by_dtype in sorted(_groups(tree, scope_fn).items()):
        nonfinite = max_abs = l2sq = None
        for leaves in by_dtype.values():
            f = (torch.cat(leaves) if len(leaves) > 1 else leaves[0]).to(
                torch.float32)
            finite = torch.isfinite(f)
            nf = (~finite).sum(dtype=torch.int32)
            # nan-proof magnitudes: one nan would blind the z-score
            # streams to the spike they should report
            f = torch.where(finite, f, f.new_zeros(()))
            mx = f.abs().amax()
            sq = (f * f).sum()
            nonfinite = nf if nonfinite is None else nonfinite + nf
            max_abs = mx if max_abs is None else torch.maximum(max_abs, mx)
            l2sq = sq if l2sq is None else l2sq + sq
        out[scope_name] = {"nonfinite": nonfinite, "max_abs": max_abs,
                           "l2": torch.sqrt(l2sq)}
    return out


def host_stats_by_scope(tree: Mapping[str, Any],
                        scope_fn=scope_of_param
                        ) -> Dict[str, Dict[str, float]]:
    """Numpy twin of ``stats_by_scope`` (same rows, plain numbers);
    takes numpy arrays or tensors, and skips the leaves it skips."""
    groups: Dict[str, List[np.ndarray]] = {}
    for name in sorted(tree):
        leaf = tree[name]
        if hasattr(leaf, "is_floating_point") and not _counted(leaf):
            continue
        arr = _as_numpy(leaf)
        if not np.issubdtype(arr.dtype, np.inexact):
            continue
        groups.setdefault(scope_fn(name), []).append(arr)
    out: Dict[str, Dict[str, float]] = {}
    for scope_name in sorted(groups):
        nonfinite, max_abs, l2sq = 0, 0.0, 0.0
        for arr in groups[scope_name]:
            # f64 accumulation: a poisoned leaf near f32-max must not
            # overflow the l2 stream into inf
            f = arr.astype(np.float64)
            finite = np.isfinite(f)
            nonfinite += int((~finite).sum())
            f = np.where(finite, f, 0.0)
            if f.size:
                with np.errstate(over="ignore"):
                    max_abs = max(max_abs, float(np.max(np.abs(f))))
                    l2sq += float(np.sum(f * f))
        out[scope_name] = {"nonfinite": nonfinite, "max_abs": max_abs,
                           "l2": math.sqrt(l2sq)}
    return out


def _as_numpy(x) -> np.ndarray:
    """A numpy array of a tensor (bfloat16 as float32: numpy has no
    bfloat16) or of anything numpy takes."""
    if hasattr(x, "detach") and hasattr(x, "dtype"):
        import torch
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(x)


# -- fingerprints -------------------------------------------------------------

_FP_MULT = 1000003   # FNV-ish odd multiplier; uint32 wraparound is the mod
_FP_INIT = 2166136261
_MASK = 0xFFFFFFFF


def _leaf_sum(leaf):
    """The uint32-wraparound sum of a leaf's bit lanes, as a 0-d int64
    tensor in [0, 2**32): float32 viewed as int32, 2-byte types as
    int16, 1-byte as int8, each masked to its unsigned value, summed in
    int64; wider floats fingerprint their float32 projection, integers
    their value mod 2**32 (the JAX module's lanes)."""
    import torch
    a = leaf.detach().reshape(-1)
    if a.is_floating_point() and a.element_size() > 4:
        a = a.to(torch.float32)
    size = a.element_size()
    if a.is_floating_point() or a.dtype == torch.bool:
        a = a.view({4: torch.int32, 2: torch.int16,
                    1: torch.int8}[size])
    if size == 4 or size == 8:
        # x mod 2**32 sums to the same residue as its masked lanes
        return a.sum(dtype=torch.int64) & _MASK
    lanes = a.to(torch.int64) & ((1 << (8 * size)) - 1)
    return lanes.sum() & _MASK


_fp_weights: Dict[Any, Any] = {}


def _weights(n, device):
    """(low, high) 16-bit halves of M**(n-1-i) mod 2**32, i < n, as int64
    tensors on `device`, made once (a host-to-device copy cannot run
    inside a capture; the step's warm-up makes them first)."""
    import torch
    key = (n, str(device))
    got = _fp_weights.get(key)
    if got is None:
        w = torch.tensor([pow(_FP_MULT, n - 1 - i, 1 << 32)
                          for i in range(n)], dtype=torch.int64,
                         device=device)
        got = _fp_weights[key] = (w & 0xFFFF, w >> 16)
    return got


def fingerprint_tree(tree: Mapping[str, Any]):
    """Order-sensitive uint32 fingerprint of a flat name -> tensor dict,
    as a 0-d int64 tensor on the leaves' device (no host read):
    fp = fp * 1000003 + leaf_sum (mod 2**32) in name order, the JAX
    module's value bit for bit. Computed in one pass: with n leaves,
    fp = init * M**n + sum_i s_i * M**(n-1-i) (mod 2**32), each product
    split at 16 bits so no int64 overflows."""
    import torch
    names = sorted(tree)
    if not names:
        return torch.tensor(_FP_INIT, dtype=torch.int64)
    sums = torch.stack([_leaf_sum(tree[k]) for k in names])
    n = len(names)
    lo, hi = _weights(n, sums.device)
    # s * w = s * hi * 2**16 + s * lo; mod 2**32 only (s * hi) mod 2**16
    # matters in the first term (s, w < 2**32: each product < 2**48)
    acc = ((sums * hi) & 0xFFFF).sum() * 65536 + (sums * lo).sum()
    head = (_FP_INIT * pow(_FP_MULT, n, 1 << 32)) & _MASK
    return (acc + head) & _MASK


def _host_leaf_bits_u32(arr: np.ndarray) -> np.ndarray:
    a = np.asarray(arr)
    if a.dtype == np.float32:
        return np.ascontiguousarray(a).reshape(-1).view(np.uint32)
    if a.dtype.itemsize == 2:
        return np.ascontiguousarray(a).reshape(-1).view(
            np.uint16).astype(np.uint32)
    if a.dtype.itemsize == 1:
        return np.ascontiguousarray(a).reshape(-1).view(
            np.uint8).astype(np.uint32)
    if np.issubdtype(a.dtype, np.floating):
        return np.ascontiguousarray(a.astype(np.float32)).reshape(
            -1).view(np.uint32)
    return a.reshape(-1).astype(np.uint32)


def _host_bits(x) -> np.ndarray:
    """The uint32 lanes of a leaf (a bfloat16 tensor by its own 16 bits,
    which numpy cannot hold as a float)."""
    if hasattr(x, "detach") and hasattr(x, "dtype"):
        import torch
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().reshape(-1).view(
                np.uint16).astype(np.uint32)
        return _host_leaf_bits_u32(t.numpy())
    return _host_leaf_bits_u32(np.asarray(x))


def host_fingerprint(tree: Mapping[str, Any]) -> int:
    """Numpy twin of ``fingerprint_tree``: the same value, a plain int
    (takes numpy arrays or tensors)."""
    fp = _FP_INIT
    for name in sorted(tree):
        leaf_sum = int(np.sum(_host_bits(tree[name]),
                              dtype=np.uint64) & _MASK)
        fp = (fp * _FP_MULT + leaf_sum) & _MASK
    return fp


# -- configuration ------------------------------------------------------------

@dataclass
class SentryConfig:
    """Knobs for the sentry. ``fingerprint_every``: the in-graph probe
    period K (0 disables the probe). ``window``/``z_threshold``: the
    rolling spike detector. ``min_clean_for_healthy``: how many
    consecutive anomaly-free observations certify a checkpoint."""
    fingerprint_every: int = 16
    window: int = 16
    z_threshold: float = 8.0
    min_warmup: int = 4          # observations before z-scores arm
    min_clean_for_healthy: int = 1
    fatal_nonfinite: bool = False   # raise NumericFault on nonfinite
    fatal_spike: bool = False       # ... and on a param-stream spike


class NumericFault(RuntimeError):
    """A fatal numeric-integrity violation the policy asked to halt on.
    Carries the anomaly record for the quarantine path."""

    def __init__(self, reason: str, anomaly: Optional[dict] = None):
        super().__init__(reason)
        self.anomaly = dict(anomaly or {})


# -- the host-side monitor ----------------------------------------------------

class SentryMonitor:
    """Rolling z-score spike detector + health bookkeeping over the
    sentry's stat streams. Feed it ``observe(step, stats, loss=...)``
    each step and ``observe_fingerprint`` at probe steps. Anomalies are
    recorded loudly (always-on counter + flight-recorder event) whether
    or not the hot-path metrics gate is up."""

    def __init__(self, config: Optional[SentryConfig] = None):
        self.config = config or SentryConfig()
        self._windows: Dict[Tuple[str, str, str], collections.deque] = {}
        self.anomalies: List[dict] = []
        self.last_step: Optional[int] = None
        self.last_loss_finite = True
        self.last_fingerprint: Optional[int] = None
        self.last_fingerprint_step: Optional[int] = None
        self._prev_fingerprint_step: Optional[int] = None
        # the newest probe step at which the replicas agreed
        self.last_agreed_probe_step: Optional[int] = None
        self._clean_streak = 0
        self._anomaly_steps: set = set()
        self._last_streak_step: Optional[int] = None

    # -- observations --------------------------------------------------
    def _spike(self, key, value: float) -> Optional[float]:
        """z-score of `value` against the stream's rolling window when
        it exceeds the threshold (None otherwise); the window is only
        extended after the check, so a spike cannot vouch for itself."""
        cfg = self.config
        win = self._windows.setdefault(
            key, collections.deque(maxlen=max(2, cfg.window)))
        z = None
        if len(win) >= max(1, cfg.min_warmup):
            mean = sum(win) / len(win)
            var = sum((v - mean) ** 2 for v in win) / len(win)
            std = math.sqrt(var)
            floor = max(1e-12, 1e-6 * abs(mean))
            z = abs(value - mean) / max(std, floor)
            if z < cfg.z_threshold:
                z = None
        win.append(value)
        return z

    def _record_anomaly(self, step: int, kind: str, **fields) -> dict:
        rec = {"step": int(step), "kind": kind, "ts": time.time()}
        rec.update(fields)
        self.anomalies.append(rec)
        self._anomaly_steps.add(int(step))
        self._clean_streak = 0
        _obs.counter("sentry.anomalies_total", _always=True,
                     kind=kind).add(1)
        _fr.record("sentry.anomaly",
                   **{("fault" if k == "kind" else k): v
                      for k, v in rec.items() if k != "ts"})
        return rec

    def observe(self, step: int, stats: Mapping[str, Mapping[str, Any]],
                kind: str = "grad", loss=None) -> List[dict]:
        """Feed one step's per-scope stats (host values). `kind` labels
        the stream family ("grad" for pre-sync gradients, "param" for
        the updated parameters). Returns the anomalies flagged at this
        step (also recorded). Raises NumericFault per the config's
        fatal_* policy after recording."""
        cfg = self.config
        self.last_step = int(step)
        flagged: List[dict] = []
        if loss is not None:
            lf = bool(np.isfinite(np.asarray(loss)).all())
            self.last_loss_finite = lf
            if not lf:
                flagged.append(self._record_anomaly(
                    step, "loss_nonfinite", stream=f"{kind}.loss"))
        clean = True
        for scope_name in sorted(stats):
            row = stats[scope_name]
            nonfinite = int(np.asarray(row.get("nonfinite", 0)))
            if nonfinite:
                clean = False
                flagged.append(self._record_anomaly(
                    step, "nonfinite", scope=scope_name,
                    stream=f"{kind}.nonfinite", count=nonfinite))
            for stat in ("max_abs", "l2"):
                if stat not in row:
                    continue
                v = float(np.asarray(row[stat]))
                if _obs._enabled:
                    _obs.gauge(f"sentry.{kind}_{stat}",
                               scope=scope_name).set(v)
                if not math.isfinite(v):
                    clean = False
                    flagged.append(self._record_anomaly(
                        step, "spike", scope=scope_name,
                        stream=f"{kind}.{stat}", value=v,
                        z=float("inf")))
                    continue
                z = self._spike((scope_name, stat, kind), v)
                if z is not None:
                    clean = False
                    flagged.append(self._record_anomaly(
                        step, "spike", scope=scope_name,
                        stream=f"{kind}.{stat}", value=v,
                        z=round(z, 2)))
        if clean and int(step) not in self._anomaly_steps \
                and self._last_streak_step != int(step):
            self._clean_streak += 1
            self._last_streak_step = int(step)
        if _obs._enabled:
            _obs.gauge("sentry.clean_window").set(self._clean_streak)
        fatal = None
        if cfg.fatal_nonfinite:
            fatal = next((a for a in flagged
                          if a["kind"] in ("nonfinite",
                                           "loss_nonfinite")
                          and not str(a.get("stream", "")
                                      ).startswith("param.")), None)
        if fatal is None and cfg.fatal_spike:
            fatal = next((a for a in flagged
                          if a["kind"] == "spike"
                          and a["stream"].startswith("param.")), None)
        if fatal is not None:
            raise NumericFault(
                f"numeric fault at step {step}: {fatal['kind']} "
                f"({fatal.get('stream')})", anomaly=fatal)
        return flagged

    def observe_fingerprint(self, step: int, fp: int) -> int:
        """Record this rank's param fingerprint at a probe step."""
        fp = int(fp) & _MASK
        self.last_fingerprint = fp
        self._prev_fingerprint_step = self.last_fingerprint_step
        self.last_fingerprint_step = int(step)
        _fr.record("sentry.fingerprint", step=int(step), fp=fp)
        if _obs._enabled:
            _obs.gauge("sentry.fingerprint").set(fp)
        return fp

    def judge_fingerprints(self, rank: int, my_fp: int,
                           peer_fps: Mapping[int, int],
                           step: Optional[int] = None
                           ) -> Optional[int]:
        """Cross-replica agreement: given my fingerprint and my peers'
        (rank -> fp) at the same probe step, name the diverging rank:
        the minority holder when a majority exists; at an even split,
        the rank with a local anomaly since the probe that last agreed.
        None = agreement, or divergence that cannot be pinned on one
        rank (recorded as a mismatch either way)."""
        votes: Dict[int, List[int]] = {}
        votes.setdefault(int(my_fp) & _MASK, []).append(int(rank))
        for r, fp in peer_fps.items():
            votes.setdefault(int(fp) & _MASK, []).append(int(r))
        if len(votes) <= 1:
            self.last_agreed_probe_step = (
                int(step) if step is not None
                else self.last_fingerprint_step)
            return None
        sizes = sorted((len(rs) for rs in votes.values()), reverse=True)
        ranks_by_size = sorted(votes.values(), key=len)
        culprit: Optional[int] = None
        if len(sizes) == 2 and sizes[0] > sizes[1] \
                and len(ranks_by_size[0]) == 1:
            culprit = ranks_by_size[0][0]
            source = "minority_vote"
        else:
            since = self._prev_fingerprint_step
            local_dirty = any(
                a for a in self.anomalies
                if a["kind"] in ("spike", "nonfinite",
                                 "loss_nonfinite")
                and (since is None or a["step"] > since))
            culprit = int(rank) if local_dirty else None
            source = "local_anomaly" if culprit is not None else "tie"
        _obs.counter("sentry.fingerprint_mismatches_total",
                     _always=True).add(1)
        _fr.record("sentry.mismatch",
                   step=int(step if step is not None
                            else (self.last_step or -1)),
                   my_fp=int(my_fp) & _MASK,
                   peers={str(r): int(f) & _MASK
                          for r, f in peer_fps.items()},
                   culprit=culprit, source=source)
        self._record_anomaly(
            int(step if step is not None else (self.last_step or -1)),
            "mismatch", culprit=culprit, source=source)
        return culprit

    # -- health stamp --------------------------------------------------
    def health_stamp(self, step: Optional[int] = None) -> dict:
        """The certification a checkpoint's manifest carries: healthy
        when the last observed loss was finite and the monitor has seen
        ``min_clean_for_healthy`` consecutive anomaly-free steps."""
        step = self.last_step if step is None else int(step)
        healthy = (self.last_loss_finite
                   and self._clean_streak
                   >= self.config.min_clean_for_healthy)
        return {
            "version": 1,
            "step": step,
            "loss_finite": bool(self.last_loss_finite),
            "clean_window": int(self._clean_streak),
            "anomalies_total": len(self.anomalies),
            "fingerprint": self.last_fingerprint,
            "healthy": bool(healthy),
        }

    @property
    def clean_window(self) -> int:
        return self._clean_streak


# -- the in-graph builder -----------------------------------------------------

_STATS = ("nonfinite", "max_abs", "l2")


class NumericSentry:
    """The object a TrainStep takes as ``sentry=``: a SentryConfig, the
    host-side monitor, and the in-graph builders the step calls. The
    step counter and the last fingerprint ride strategy_state, so the
    every-K probe needs no new program input."""

    STATE_STEP = "sentry_step"
    STATE_FP = "sentry_fp"

    def __init__(self, config: Optional[SentryConfig] = None,
                 monitor: Optional[SentryMonitor] = None):
        self.config = config or SentryConfig()
        self.monitor = monitor or SentryMonitor(self.config)

    def init_state(self, strategy_state: Dict[str, Any], device=None):
        """The sentry's entries of strategy_state (kept when present): the
        step counter (int32) and the fingerprint (int64 holding the
        uint32 value), 0-d tensors on `device` (default: the CPU)."""
        import torch
        strategy_state.setdefault(
            self.STATE_STEP, torch.zeros((), dtype=torch.int32,
                                         device=device))
        strategy_state.setdefault(
            self.STATE_FP, torch.zeros((), dtype=torch.int64,
                                       device=device))

    def instrument(self, grads: Optional[Mapping[str, Any]],
                   new_params: Mapping[str, Any], loss,
                   strat: Dict[str, Any], grad_stats=None
                   ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Inside the step: the sentry's outputs and the updated
        strategy entries, all on the card. grad_stats, when given, are
        stats_by_scope of the pre-sync gradients taken earlier (a
        TrainStep computes them before its gradient sync rewrites the
        gradients in place; grads is then not read). The strategy
        tensors are written in place (a captured graph holds their
        addresses). Returns (sentry_out, strat); sentry_out["packed"] is
        every scalar in one float64 tensor, in the order ``consume``
        reads."""
        import torch
        sstep = strat[self.STATE_STEP]
        gstats = grad_stats if grad_stats is not None \
            else stats_by_scope(grads)
        out: Dict[str, Any] = {
            "grad": gstats,
            "param": stats_by_scope(new_params),
            "loss_finite": torch.isfinite(
                torch.as_tensor(loss).to(torch.float32)).reshape(()),
        }
        k = int(self.config.fingerprint_every)
        if k > 0:
            fresh = (sstep % k) == 0
            fp = torch.where(fresh, fingerprint_tree(new_params),
                             strat[self.STATE_FP])
            strat[self.STATE_FP].copy_(fp)
            out["fp"] = strat[self.STATE_FP]
            out["fp_fresh"] = fresh
        out["step"] = sstep.clone()
        strat[self.STATE_STEP].add_(1)
        out["packed"] = torch.stack(
            [v.to(torch.float64).reshape(())
             for v in _packed_leaves(out)])
        return out, strat

    def consume(self, step: int, sentry_out: Mapping[str, Any]
                ) -> List[dict]:
        """Host side of the per-step loop: every scalar in one
        device-to-host copy (sentry_out["packed"]), then the monitor fed
        (grad streams first, the pre-sync tell)."""
        host = unpack(sentry_out)
        flagged = self.monitor.observe(
            step, host.get("grad", {}), kind="grad",
            loss=(1.0 if host["loss_finite"] else float("nan")))
        flagged += self.monitor.observe(
            step, host.get("param", {}), kind="param")
        if "fp" in host and host.get("fp_fresh"):
            self.monitor.observe_fingerprint(step, int(host["fp"]))
        return flagged


def _packed_leaves(out):
    """The 0-d tensors of a sentry output in packing order: grad then
    param rows (scope order, nonfinite/max_abs/l2), loss_finite, fp,
    fp_fresh, step."""
    for fam in ("grad", "param"):
        for scope_name in sorted(out[fam]):
            for stat in _STATS:
                yield out[fam][scope_name][stat]
    yield out["loss_finite"]
    for key in ("fp", "fp_fresh"):
        if key in out:
            yield out[key]
    yield out["step"]


def unpack(sentry_out: Mapping[str, Any]) -> Dict[str, Any]:
    """The host values of a sentry output, from ONE copy of its packed
    tensor: {"grad": {scope: {stat: value}}, "param": ..., "loss_finite":
    bool, "fp": int, "fp_fresh": bool, "step": int}."""
    vals = iter(sentry_out["packed"].cpu().tolist())
    host: Dict[str, Any] = {}
    for fam in ("grad", "param"):
        host[fam] = {}
        for scope_name in sorted(sentry_out[fam]):
            row = {stat: next(vals) for stat in _STATS}
            row["nonfinite"] = int(row["nonfinite"])
            host[fam][scope_name] = row
    host["loss_finite"] = bool(next(vals))
    if "fp" in sentry_out:
        host["fp"] = int(next(vals))
        host["fp_fresh"] = bool(next(vals))
    host["step"] = int(next(vals))
    return host


# -- fault captures (replay triage) ------------------------------------------

def write_fault_capture(path: str, params: Mapping[str, Any],
                        batch: Mapping[str, Any],
                        observed: Optional[dict] = None,
                        rng_state: Any = None, step: int = -1,
                        rank: int = -1,
                        meta: Optional[dict] = None) -> str:
    """Snapshot everything a re-execution needs: params, the exact
    batch, the rng state, and the stats the sentry observed at fault
    time, as an npz (tensors are written as numpy arrays, bfloat16 as
    its float32 values)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    import json
    doc = {
        "version": 1, "step": int(step), "rank": int(rank),
        "ts": time.time(),
        "param_names": sorted(params),
        "batch_names": sorted(batch),
        "observed": observed or {},
        "meta": meta or {},
        "rng_state": rng_state,
    }
    arrays = {f"param__{k}": _as_numpy(v) for k, v in params.items()}
    arrays.update({f"batch__{k}": _as_numpy(v)
                   for k, v in batch.items()})
    arrays["__doc__"] = np.frombuffer(
        json.dumps(doc, default=str).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    _fr.record("sentry.fault_capture", path=path, step=int(step),
               rank=int(rank))
    return path


def load_fault_capture(path: str) -> dict:
    """Inverse of ``write_fault_capture``: {'params', 'batch', 'step',
    'rank', 'observed', 'meta'}."""
    import json
    with np.load(path, allow_pickle=False) as z:
        doc = json.loads(bytes(z["__doc__"].tobytes()).decode())
        params = {k[len("param__"):]: z[k] for k in z.files
                  if k.startswith("param__")}
        batch = {k[len("batch__"):]: z[k] for k in z.files
                 if k.startswith("batch__")}
    doc["params"] = params
    doc["batch"] = batch
    return doc
