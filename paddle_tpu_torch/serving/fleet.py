"""SLO-aware self-healing serving fleet (counterpart of
paddle_tpu/serving/fleet.py): N ServingEngine replicas behind one
priority queue, driven by the elastic supervisor's state machine.

Every fleet tick (one token boundary across the fleet):

  poll chaos -> detect dead/wedged replicas -> remediate (evict + EXACT
  requeue, receipt) -> autoscale against the SLO -> grow -> flip one
  pending weight swap -> dispatch queued requests -> step every live
  replica -> harvest emitted tokens

**Exact requeue.** Page reservation is whole-lifetime, so a request is
fully described by its prompt and its emitted tokens; the fleet harvests
every replica's tokens at every tick, so a replica dying mid-decode
costs nothing already streamed. Resume re-submits ``prompt + emitted``
with the remaining budget; under the f32 greedy parity contract the
suffix equals the uninterrupted stream (the constructor checks that the
prefill ladder covers every resumable prefix). Requeued requests go to
the front of their class queue.

**Verdict-driven remediation.** Engine gone = ``crash``; no pulse for
``stall_ticks`` ticks = ``hang``. Decisions come from the training
supervisor's ``SupervisorPolicy`` (backoff, budgets, evict-shrink with a
``min_replicas`` floor, cooldown grow); every episode emits one
``elastic.emit_receipt`` receipt naming the replica. A replica the fleet
kills or retires releases its engine (``ServingEngine.release``: its
CUDA graphs, page pools and weight snapshot), so its card memory goes
back; a respawn captures its bucket graphs anew, each counted by
``sentinel.count_capture``.

**SLO autoscale.** ``serving.fleet.*`` gauges (queue depth, rolling p99
TTFT, tokens/s, live replicas) feed ``SupervisorPolicy.decide_scale``:
``scale_up`` spawns a spare slot, ``scale_down`` drains the highest one
(it finishes its requests, admits nothing, then retires).

**Hot weight swap.** ``swap_weights()`` builds a standby snapshot once
(from a model, a params dict, or a checkpoint written by
``distributed.checkpoint.save_sharded``), checks it (finite floats: the
corrupt-swap guard), then flips one replica per tick at a token
boundary through ``ServingEngine.swap_weights``: an in-place copy into
the snapshot the captured graphs read, so nothing is recaptured. A
poisoned standby aborts the swap with a receipt; the old weights keep
serving.

Priority classes: ``submit(cls=...)``, classes high -> low (default
``("interactive", "batch")``); dispatch strictly by class, FIFO within;
under overload the lowest class is shed at admission beyond
``ServingSLO.shed_queue_depth`` (returned with ``shed=True`` and
counted, never dropped in silence).

Chaos (``PD_CHAOS_MODE`` in kill|stall|corrupt_swap) reaches replicas
through ``chaos.maybe_inject_serving``, polled for each live replica
every tick.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed import chaos as _chaos
from ..distributed import elastic as _elastic
from ..models.generation import _gpt_params
from ..observability import decisions as _dec
from ..observability import fleet as _obs_fleet
from ..observability import flight_recorder as _fr
from ..observability import memory as _mem
from ..observability import metrics as _obs
from ..observability import reqtrace as _rt
from ..observability import timeseries as _ts
from ..serialization import from_numpy
from .engine import (ServingConfig, ServingEngine, _leaves,
                     build_serving_snapshot)
from .scheduler import BucketLadder, Request

__all__ = ["ServingSLO", "FleetConfig", "FleetRequest", "Replica",
           "ServingFleet", "PRIORITY_CLASSES"]

PRIORITY_CLASSES: Tuple[str, ...] = ("interactive", "batch")

_frid_counter = itertools.count()


@dataclass
class ServingSLO:
    """The declared service-level objective the supervisor scales and
    sheds against. ``queue_high``/``queue_low`` are queued-requests-
    per-live-replica watermarks; ``p99_ttft_ms`` both triggers
    scale_up on breach and is the recovery bar chaos drills check.

    ``target`` is the availability objective — the fraction of
    requests that must meet ``p99_ttft_ms``; its complement is the
    ERROR BUDGET the ``reqtrace.BurnMeter`` burns against over the
    rolling ``burn_windows`` (fast, slow; seconds). The multi-window
    alert (every window burning above ``burn_alert_rate``) is the
    forward-looking scale signal ``decide_scale`` reads next to the
    instantaneous p99, published as
    ``serving.slo.burn_rate{window=}``."""
    p99_ttft_ms: float = 1000.0
    queue_high: int = 8
    queue_low: int = 1
    shed_queue_depth: int = 64      # lowest class sheds beyond this
    ttft_window: int = 64           # rolling finishes for p99/tokens-s
    target: float = 0.99            # SLO: fraction meeting p99_ttft_ms
    burn_windows: Tuple[float, float] = (5.0, 60.0)  # fast, slow (s)
    burn_alert_rate: float = 1.0    # page when EVERY window burns past


@dataclass
class FleetConfig:
    """Fleet topology + control-loop knobs (the ServingConfig stays
    the per-replica shape contract)."""
    replicas: int = 2               # initial live replicas
    min_replicas: int = 1
    max_replicas: int = 4
    classes: Tuple[str, ...] = PRIORITY_CLASSES  # high -> low priority
    autoscale: bool = True
    scale_cooldown_s: float = 3.0
    stall_ticks: int = 12           # missed heartbeat pulses = hang
    grow_after_s: float = 0.0       # re-admit evicted slots (0 = never)
    requeue: bool = True
    shed: bool = True               # overload-shed the lowest class
    max_restarts: int = 8
    restart_window_s: float = 60.0
    restart_budget: int = 0
    backoff_base: float = 0.0       # serving: don't sleep by default
    warmup_on_spawn: bool = True
    snapshot_timeout_s: float = 1.0  # aggregate(): per-replica budget
    receipts_dir: Optional[str] = None

    def __post_init__(self):
        if not (1 <= self.min_replicas <= self.replicas
                <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas({self.min_replicas}) <= "
                f"replicas({self.replicas}) <= "
                f"max_replicas({self.max_replicas})")
        if len(self.classes) < 1:
            raise ValueError("need at least one priority class")
        if len(set(self.classes)) != len(self.classes):
            raise ValueError(f"duplicate priority class in "
                             f"{self.classes}")


@dataclass
class FleetRequest:
    """One fleet-level request: survives replica death (the engine
    Request is per-admission and dies with its replica)."""
    ids: np.ndarray
    max_new_tokens: int
    cls: str = PRIORITY_CLASSES[0]
    rid: object = None
    eos_token_id: Optional[int] = None
    arrival: Optional[float] = None
    # -- runtime --------------------------------------------------------------
    emitted: List[int] = field(default_factory=list)
    base: List[int] = field(default_factory=list)  # emitted at (re)submit
    replica: Optional[int] = None       # live assignment (slot id)
    evictions: int = 0
    # last eviction (reqtrace: the requeue hop span evict->re-dispatch)
    evicted_ts: Optional[float] = None
    evicted_from: Optional[int] = None
    evicted_kind: Optional[str] = None
    shed: bool = False
    first_token_ts: Optional[float] = None
    done_ts: Optional[float] = None
    finish_reason: Optional[str] = None

    def __post_init__(self):
        self.ids = np.asarray(self.ids, np.int32).reshape(-1)
        if self.rid is None:
            self.rid = f"f{next(_frid_counter)}"

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    @property
    def remaining(self) -> int:
        return int(self.max_new_tokens) - len(self.base)

    def resume_ids(self) -> np.ndarray:
        """The replay prompt: original prompt + every token already
        streamed — all the state an exact resume needs."""
        if not self.base:
            return self.ids
        return np.concatenate(
            [self.ids, np.asarray(self.base, np.int32)])


class Replica:
    """One engine slot plus its health state. States: active ->
    (draining | dead); draining retires itself, dead is evicted by
    the control loop. A STALL is covert by design: the replica stays
    "active" (the router keeps dispatching to it — exactly why exact
    requeue matters) but stops pulsing; the missed-pulse clock
    (``FleetConfig.stall_ticks``) catches it, the in-process twin of
    the heartbeat monitor.

    On the card the replica keeps what its spawn cost: ``warmup_s`` (the
    engine build and its captures) and ``mem_before_spawn`` (the
    allocator's bytes just before)."""

    def __init__(self, slot: int, engine: ServingEngine,
                 incarnation: int = 0, born_tick: int = 0):
        self.slot = int(slot)
        self.engine: Optional[ServingEngine] = engine
        self.state = "active"
        self.incarnation = int(incarnation)
        self.last_pulse_tick = int(born_tick)
        self.wedged_until = 0.0
        self.finished_total = 0
        self.tokens_total = 0
        self.warmup_s = 0.0
        self.mem_before_spawn: Optional[int] = None

    @property
    def alive(self) -> bool:
        return self.engine is not None and self.state != "dead"

    def load(self) -> int:
        if not self.alive:
            return 1 << 30
        return (self.engine.sched.n_running
                + self.engine.sched.queue_depth)

    def snapshot(self) -> Dict[str, dict]:
        """Per-replica stats in metric-snapshot shape, mergeable by
        ``observability.fleet.merge_snapshots`` (the process registry
        is shared across replicas, so per-replica numbers come from
        the engine itself). Raises when the replica is dead — the
        fleet rollup skips-and-flags it."""
        if self.engine is None:
            raise RuntimeError(f"replica {self.slot} is dead")
        e = self.engine
        g = lambda v: {"type": "gauge", "value": v}        # noqa: E731
        c = lambda v: {"type": "counter", "value": v}      # noqa: E731
        return {
            "serving.replica.queue_depth": g(e.sched.queue_depth),
            "serving.replica.running": g(e.sched.n_running),
            "serving.replica.pages_free": g(e.cache.n_free),
            "serving.replica.pages_live": g(e.cache.n_live),
            "serving.replica.executables": g(e.executable_count()),
            "serving.replica.recompile_events": c(e.sentinel.fired),
            "serving.replica.finished_total": c(self.finished_total),
            "serving.replica.tokens_total": c(self.tokens_total),
            "serving.replica.state": g(self.state),
            "serving.replica.incarnation": g(self.incarnation),
        }


class ServingFleet:
    """N self-healing ServingEngine replicas behind one priority queue."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 slo: Optional[ServingSLO] = None,
                 fleet: Optional[FleetConfig] = None,
                 draft_model=None):
        self._model = model
        self._draft_model = draft_model
        self.config = cfg = config or ServingConfig()
        self.slo = slo or ServingSLO()
        self.fleet = fc = fleet or FleetConfig()
        if fc.requeue and cfg.prefill_buckets[-1] < \
                cfg.max_total_tokens - 1:
            raise ValueError(
                f"requeue needs the prefill ladder to cover every "
                f"resumable prefix: largest bucket "
                f"{cfg.prefill_buckets[-1]} < max_total_tokens-1 = "
                f"{cfg.max_total_tokens - 1} (an evicted request that "
                "already emitted tokens could become unservable). "
                "Widen prefill_buckets or set FleetConfig.requeue="
                "False.")
        # shape validation without an engine (fleet-level admission)
        self._ladder = BucketLadder(cfg.prefill_buckets,
                                    cfg.decode_buckets, cfg.block_size)
        self.policy = _elastic.SupervisorPolicy(
            world=fc.max_replicas, initial_world=fc.replicas,
            policy="rank", allow_shrink=True, min_world=fc.min_replicas,
            max_restarts=fc.max_restarts,
            restart_window_s=fc.restart_window_s,
            restart_budget=fc.restart_budget,
            backoff_base=fc.backoff_base,
            grow_after_s=fc.grow_after_s,
            scale_cooldown_s=fc.scale_cooldown_s)
        self._replicas: Dict[int, Replica] = {}
        self._queues: Dict[str, List[FleetRequest]] = {
            c: [] for c in fc.classes}
        self._by_rid: Dict[object, FleetRequest] = {}
        self._tick = 0
        self._aborted = False
        self._finished_at_eviction: List[FleetRequest] = []
        self.episodes: List[dict] = []      # remediation receipts
        self.requeued_total = 0
        self.shed_total = 0
        self.swaps_total = 0
        self.swaps_aborted = 0
        self._standby = None                # pending weight pool
        self._current_params = None         # latest COMPLETED deploy
        self._standby_version = 0
        self._flip_pending: List[int] = []
        self._swap_evidence = None          # staged swap's ledger evidence
        self._swap_sabotage = False         # armed by corrupt_swap chaos
        self._retired_recompiles = 0        # sentinel fires of dead engines
        self._retired_executables = 0
        # rolling SLO window: (finish_ts, ttft_ms, cls, n_tokens)
        self._window: List[Tuple[float, float, str, int]] = []
        # SLO error-budget burn accounting (always maintained — the
        # autoscaler consumes it, like _window; gauges gate in _publish)
        self._burn = _rt.BurnMeter(
            budget=1.0 - float(self.slo.target),
            windows=self.slo.burn_windows,
            alert_rate=self.slo.burn_alert_rate)
        for slot in list(self.policy.active):
            self._replicas[slot] = self._spawn(slot)

    # -- spawn / weights ------------------------------------------------------
    def _spawn(self, slot: int, incarnation: int = 0) -> Replica:
        dev = next(self._model.parameters()).device
        mem0 = (torch.cuda.memory_allocated(dev) if dev.type == "cuda"
                else None)
        t0 = time.perf_counter()
        eng = ServingEngine(self._model, self.config,
                            draft_model=self._draft_model)
        if self.fleet.warmup_on_spawn:
            eng.warmup()
        if self._standby is not None or self._standby_version:
            # a replica born after a swap must serve the CURRENT
            # weights, not the build-time model snapshot
            cur = self._standby if self._standby is not None \
                else self._current
            eng.swap_weights(cur, cast=False)
        eng.trace_replica = int(slot)   # request-trace lane label
        rep = Replica(slot, eng, incarnation, born_tick=self._tick)
        rep.warmup_s = time.perf_counter() - t0
        rep.mem_before_spawn = mem0
        return rep

    @property
    def _current(self):
        # the latest fully-deployed weight pool. Tracked explicitly
        # (_flip_one records it at swap completion): deriving it from
        # "any live flipped replica" reverted a whole-fleet respawn
        # after a completed swap to the BUILD-TIME snapshot when no
        # live replica survived the episode to read it from.
        if self._current_params is not None:
            return self._current_params
        return build_serving_snapshot(_gpt_params(self._model),
                                      self.config)

    def swap_weights(self, source=None, checkpoint_path: Optional[str]
                     = None, verify: bool = True) -> bool:
        """Stage a hot weight swap: build the standby pool ONCE (from
        a model, a raw f32 params pytree, or a checkpoint written by
        the async-checkpoint plane), sanity-check it, then flip one
        replica per tick at a token boundary. Returns False (and emits
        a ``swap_aborted`` receipt) when the standby fails
        verification — the old weights keep serving."""
        if checkpoint_path is not None:
            if source is not None:
                raise ValueError("pass source or checkpoint_path, "
                                 "not both")
            from ..distributed import checkpoint as _ckpt
            source = _ckpt.load_sharded(checkpoint_path)
        if isinstance(source, dict) and "params" in source:
            # the async-checkpoint plane (and this repo's drills) save
            # {"params": <pytree>} wrappers; the GPT params pytree
            # itself has no "params" key, so unwrapping is unambiguous
            source = source["params"]
        raw = _gpt_params(source) if hasattr(source, "gpt") else \
            _to_device(source, next(self._model.parameters()).device)
        # the engines' snapshot function (cast + int8 PTQ under
        # quant="int8"): any other transform would stage a standby whose
        # structure every engine rejects
        standby = build_serving_snapshot(raw, self.config)
        # compatibility is validated at STAGE time, synchronously: a
        # wrong-model standby must raise HERE at the caller, not blow
        # up the control loop ticks later inside _flip_one
        self._validate_standby_shape(standby)
        if self._swap_sabotage:
            # deterministic corrupt_swap chaos: poison the standby the
            # way a torn read from a half-written snapshot would
            self._swap_sabotage = False
            standby = dict(standby)
            standby["wte"] = torch.full_like(standby["wte"], float("nan"))
        standby_ok = (not verify) or self._verify_standby(standby)
        # the swap decision's evidence: exactly what the pure rule read
        # (verify flag + verification verdict + target version);
        # a replay re-derives the action from these inputs alone
        swap_evidence = {
            "inputs": {"verify": bool(verify),
                       "standby_ok": bool(standby_ok),
                       "version": self._standby_version + 1},
            "decision": {"action": ("weight_swap" if standby_ok
                                    else "swap_aborted")},
        }
        if not standby_ok:
            self.swaps_aborted += 1
            if _obs._enabled:
                _obs.counter("serving.swap_aborted_total").add(1)
            # aborting a corrupt standby keeps the old weights serving:
            # joined `neutral` (no movement), never `unjoined` — the
            # outcome IS known the instant the abort fires
            did = _dec.record(
                "fleet.swap", "swap_aborted",
                rule="standby failed verification",
                evidence=swap_evidence,
                signals={"completed": 0},
                post_signals={"completed": 0})
            self._emit(
                action="swap_aborted",
                verdict={"kind": "corrupt_standby", "rank": None,
                         "source": "serving_fleet",
                         "evidence": {"version":
                                      self._standby_version + 1}},
                ranks=[], reason="standby weights failed verification "
                "(non-finite floats); old snapshot keeps serving",
                decision_id=did)
            return False
        self._standby = standby
        self._standby_version += 1
        self._swap_evidence = swap_evidence
        self._flip_pending = [r.slot for r in self._replicas.values()
                              if r.alive]
        return True

    def _validate_standby_shape(self, standby):
        """Raise (engine.swap_weights's error shape) when the standby
        cannot possibly flip onto the serving snapshot: the same
        structure and per-leaf shape/dtype are required."""
        rl, sl = _leaves(self._current), _leaves(standby)
        if [p for p, _ in rl] != [p for p, _ in sl]:
            raise ValueError(
                "weight swap rejected: params tree structure differs "
                "from the serving snapshot (same model family only)")
        for (path, o), (_, n) in zip(rl, sl):
            if tuple(n.shape) != tuple(o.shape) or n.dtype != o.dtype:
                raise ValueError(
                    f"weight swap rejected: {path} is "
                    f"{tuple(n.shape)}/{n.dtype}, serving snapshot holds "
                    f"{tuple(o.shape)}/{o.dtype}: a mismatch would need "
                    "new programs")

    @staticmethod
    def _verify_standby(params) -> bool:
        for _, leaf in _leaves(params):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf).all()):
                return False
        return True

    def _flip_one(self):
        """One replica per tick flips to the standby — capacity never
        dips, and every flip lands exactly at a token boundary."""
        if self._standby is None:
            return
        while self._flip_pending:
            slot = self._flip_pending[0]
            rep = self._replicas.get(slot)
            if rep is None or not rep.alive:
                self._flip_pending.pop(0)
                continue
            t0 = time.perf_counter()
            rep.engine.swap_weights(self._standby, cast=False)
            t1 = time.perf_counter()
            _fr.record("fleet.swap_flip", replica=slot,
                       version=self._standby_version,
                       tick=self._tick,
                       dur_ms=round((t1 - t0) * 1e3, 3))
            if _rt._enabled:
                # the flip pause lands on every request the replica
                # was serving at this token boundary
                for r in rep.engine.sched.running.values():
                    _rt.record_span(r.rid, "swap_flip", t0, t1,
                                    replica=slot,
                                    version=self._standby_version)
            self._flip_pending.pop(0)
            break
        if not self._flip_pending:
            self.swaps_total += 1
            self._current_params = self._standby
            if _obs._enabled:
                _obs.counter("serving.fleet.weight_swaps_total").add(1)
            # the decision record lands at COMMIT (evidence was
            # snapshotted at stage time): every replica flipped, so the
            # outcome joins immediately as `improved` (0 -> 1 complete)
            did = _dec.record(
                "fleet.swap", "weight_swap",
                rule="standby verified; flip per-replica at token "
                     "boundaries",
                evidence=(self._swap_evidence
                          or {"inputs": {"version":
                                         self._standby_version}}),
                signals={"completed": 0},
                post_signals={"completed": 1})
            self._swap_evidence = None
            self._emit(
                action="weight_swap",
                verdict={"kind": "deploy", "rank": None,
                         "source": "serving_fleet",
                         "evidence": {"version": self._standby_version}},
                ranks=sorted(r.slot for r in self._replicas.values()
                             if r.alive),
                reason=f"hot swap v{self._standby_version} complete "
                       "(flipped per-replica at token boundaries)",
                decision_id=did)
            self._standby = None

    # -- request intake -------------------------------------------------------
    def submit(self, ids, max_new_tokens: int,
               cls: Optional[str] = None, rid=None,
               eos_token_id=None,
               arrival: Optional[float] = None) -> FleetRequest:
        """Queue one request with a priority class. Validates against
        the ladder ONCE here (fleet-level admission — a replica can
        then never refuse it); under overload the LOWEST class is shed
        beyond the SLO's queue bound, accounted via ``shed=True`` and
        ``serving.fleet.shed_total{cls=}``."""
        fc = self.fleet
        cls = fc.classes[0] if cls is None else cls
        if cls not in fc.classes:
            raise ValueError(f"unknown priority class {cls!r} "
                             f"(classes: {fc.classes})")
        fr = FleetRequest(
            ids=ids, max_new_tokens=int(max_new_tokens), cls=cls,
            rid=rid, eos_token_id=(self.config.eos_token_id
                                   if eos_token_id is None
                                   else eos_token_id),
            arrival=(time.perf_counter() if arrival is None
                     else arrival))
        if fr.ids.size < 1:
            raise ValueError("empty prompt")
        if fr.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} must be >= 1")
        total = fr.ids.size + fr.max_new_tokens
        self._ladder.pick_prefill(int(fr.ids.size))   # raises if long
        if fc.requeue:
            self._ladder.pick_prefill(total - 1)      # every prefix
        if total > self.config.max_total_tokens:
            raise ValueError(
                f"request needs {total} tokens > max_total_tokens="
                f"{self.config.max_total_tokens}")
        need = -(-total // self.config.block_size)
        if need > self.config.n_blocks - 1:
            raise ValueError(
                f"request needs {need} pages > pool size "
                f"{self.config.n_blocks - 1}")
        if (fc.shed and len(fc.classes) > 1 and cls == fc.classes[-1]
                and len(self._queues[cls]) >= self.slo.shed_queue_depth):
            fr.shed = True
            fr.finish_reason = "shed"
            self.shed_total += 1
            if _obs._enabled:
                _obs.counter("serving.fleet.shed_total", cls=cls).add(1)
            if _rt._enabled:
                _rt.mark(fr.rid, "shed", cls=cls)
            # ledger: the shed rule is pure (class + queue depth vs
            # watermark) so the evidence alone replays the action; the
            # outcome joins against the queue depth _publish observes
            # after the settle window — a drained queue means the shed
            # protected the SLO (improved)
            _dec.record(
                "fleet.shed", "shed",
                rule="lowest class beyond shed_queue_depth",
                evidence={"inputs": {
                    "cls": cls,
                    "queue_len": len(self._queues[cls]),
                    "shed_queue_depth": int(self.slo.shed_queue_depth),
                    "lowest_class": fc.classes[-1],
                    "shed_enabled": bool(fc.shed)},
                    "decision": {"action": "shed"}},
                signals={"queued": self.queue_depth},
                settle_s=0.05)
            return fr
        if _rt._enabled:
            # the request's arrival on the TRACE clock — queue wait
            # accrues from here, exactly like the TTFT accounting
            _rt.mark(fr.rid, "submit", t=fr.arrival, cls=cls)
        self._queues[cls].append(fr)
        self._by_rid[fr.rid] = fr
        return fr

    def has_work(self) -> bool:
        # _by_rid holds every accepted, unfinished request (central
        # queue, replica-local, running, AND in-flight on a dead or
        # wedged replica awaiting requeue) — asking the engines would
        # go blind exactly when the last live replica dies with work
        # still to remediate
        return bool(self._by_rid)

    @property
    def queue_depth(self) -> int:
        return (sum(len(q) for q in self._queues.values())
                + sum(rep.engine.sched.queue_depth
                      for rep in self._replicas.values() if rep.alive))

    def live_replicas(self) -> List[int]:
        return sorted(r.slot for r in self._replicas.values()
                      if r.alive and r.state == "active")

    @property
    def wedged(self) -> bool:
        """True when the fleet can never finish its queued work: it
        ABORTED (restart budgets exhausted) and no live replica
        remains. Drive loops must raise on this instead of spinning —
        step() is a no-op from here on."""
        return (self._aborted and bool(self._by_rid)
                and not any(r.alive for r in self._replicas.values()))

    # -- fault surfaces (ops + tests; chaos routes through these) ------------
    def kill_replica(self, slot: int):
        """Abrupt replica death: the engine object (and any state not
        already streamed to the router) is GONE. Detection + exact
        requeue happen on the next ``step()``."""
        rep = self._replicas[slot]
        if rep.engine is not None:
            rep.engine.release()
        rep.engine = None
        rep.state = "dead"

    def stall_replica(self, slot: int, seconds: float = 600.0):
        """Covertly wedge a replica's step loop: it stays in the
        dispatch pool (the router doesn't know yet) but stops stepping
        and pulsing — only the missed-pulse clock (``stall_ticks``)
        catches it."""
        rep = self._replicas[slot]
        rep.wedged_until = time.perf_counter() + float(seconds)

    def drain_replica(self, slot: int):
        """Graceful retirement: finish running work, admit nothing,
        then decommission (the scale_down path)."""
        rep = self._replicas[slot]
        if rep.alive:
            rep.state = "draining"

    # -- the control loop -----------------------------------------------------
    def step(self) -> List[FleetRequest]:
        """One fleet tick. Returns the requests that FINISHED."""
        self._tick += 1
        now = time.perf_counter()
        self._poll_chaos()
        failures = self._detect(now)
        if failures:
            self._remediate(failures)
        if self.fleet.autoscale and not self._aborted:
            self._autoscale()
        self._maybe_grow()
        self._flip_one()
        self._dispatch()
        finished = self._step_replicas(now)
        if self._finished_at_eviction:
            # requests whose final token had been harvested before
            # their replica died complete HERE, not via requeue
            finished = self._finished_at_eviction + finished
            self._finished_at_eviction = []
        self._publish(now)
        return finished

    def run_until_drained(self, max_ticks: int = 100000
                          ) -> List[FleetRequest]:
        done: List[FleetRequest] = []
        for _ in range(max_ticks):
            if not self.has_work():
                break
            done.extend(self.step())
            # step() remediates (respawn/evict) before giving up, so
            # only an ABORTED fleet with work left is truly wedged
            if self.wedged:
                raise RuntimeError(
                    "fleet aborted with queued work and zero live "
                    "replicas (restart budgets exhausted)")
        else:
            raise RuntimeError(
                f"run_until_drained: work left after {max_ticks} ticks")
        return done

    # -- tick phases ----------------------------------------------------------
    def _poll_chaos(self):
        for rep in list(self._replicas.values()):
            if not rep.alive:
                continue
            mode = _chaos.maybe_inject_serving(
                self._tick, rep.slot, incarnation=rep.incarnation)
            if mode == "kill":
                self.kill_replica(rep.slot)
            elif mode == "stall":
                p = _chaos.plan()
                self.stall_replica(rep.slot,
                                   p.stall_s if p else 600.0)
            elif mode == "corrupt_swap":
                self._swap_sabotage = True

    def _detect(self, now: float) -> List[Tuple[int, str]]:
        # covers every replica the fleet still holds — a DRAINING
        # slot (out of policy.active) that dies or wedges still needs
        # its in-flight requests requeued; the policy simply won't
        # respawn it (it was being decommissioned anyway)
        failures: List[Tuple[int, str]] = []
        for rep in self._replicas.values():
            if rep.engine is None or rep.state == "dead":
                failures.append((rep.slot, "replica process lost"))
            elif (self._tick - rep.last_pulse_tick
                  >= self.fleet.stall_ticks):
                failures.append(
                    (rep.slot,
                     f"step loop stalled (no pulse for "
                     f"{self._tick - rep.last_pulse_tick} ticks)"))
        return failures

    def _remediate(self, failures: List[Tuple[int, str]]):
        verdict = None
        for slot, why in failures:
            kind = "crash" if "lost" in why else "hang"
            verdict = {"kind": kind, "rank": int(slot),
                       "source": "serving_fleet",
                       "evidence": {"why": why, "tick": self._tick}}
            break
        world_before = len(self.live_replicas()) + sum(
            1 for s, _ in failures if not (
                s in self._replicas and self._replicas[s].alive
                and self._replicas[s].state == "active"))
        incarnations = {s: self._incarnation(s) for s, _ in failures}
        decision = self.policy.decide(failures, verdict)
        requeued = 0
        for slot, why in failures:
            requeued += self._evict_replica(
                slot, kind="crash" if "lost" in why else "hang")
        if decision.action == "abort":
            self._aborted = True
        else:
            # any failed slot the policy kept active (respawn_rank, or
            # a second simultaneous casualty alongside an eviction) is
            # rebuilt in place; one respawn event per episode feeds
            # the backoff/budget machinery
            for slot, _why in failures:
                if slot in self.policy.active:
                    self._replicas[slot] = self._spawn(
                        slot, incarnations[slot] + 1)
            self.policy.record_respawn()
        self._emit(
            action=decision.action, verdict=decision.verdict,
            ranks=(decision.ranks if decision.ranks
                   else [f[0] for f in failures]),
            reason=decision.reason, delay_s=decision.delay_s,
            episode=decision.episode, world_before=world_before,
            extras={"requeued": requeued,
                    "queue_depth": self.queue_depth,
                    "fleet_tick": self._tick},
            decision_id=decision.decision_id)

    def _incarnation(self, slot: int) -> int:
        rep = self._replicas.get(slot)
        return rep.incarnation if rep is not None else 0

    def _evict_replica(self, slot: int, kind: str = "crash") -> int:
        """Remove a replica and requeue its in-flight requests EXACTLY
        (prompt + streamed tokens) at the front of their class queues.
        Zero-drop: every request the replica held re-enters the
        central queue with its remaining budget."""
        rep = self._replicas.pop(slot, None)
        if rep is None:
            return 0
        self._reset_replica_gauges(slot)
        if rep.engine is not None:
            self._retired_recompiles += rep.engine.sentinel.fired
            self._retired_executables += rep.engine.executable_count()
            rep.engine.release()
            rep.engine = None      # a wedged engine is not trusted
        evict_ts = time.perf_counter()
        requeued: Dict[str, List[FleetRequest]] = {
            c: [] for c in self.fleet.classes}
        for fr in list(self._by_rid.values()):
            if fr.replica != slot or fr.done:
                continue
            fr.replica = None
            fr.base = list(fr.emitted)
            # a request whose LAST harvested token completed it (budget
            # spent or eos emitted) but that the engine had not retired
            # yet is FINISHED, not requeueable — the stream the client
            # saw is already whole
            if fr.remaining <= 0 or (
                    fr.eos_token_id is not None and fr.emitted
                    and fr.emitted[-1] == int(fr.eos_token_id)):
                fr.finish_reason = ("length" if fr.remaining <= 0
                                    else "eos")
                fr.done_ts = time.perf_counter()
                self._record_finish(fr)
                self._finished_at_eviction.append(fr)
                self._by_rid.pop(fr.rid, None)
                if _rt._enabled:
                    _rt.mark(fr.rid, "retire", t=fr.done_ts,
                             reason=fr.finish_reason)
                continue
            fr.evictions += 1
            fr.evicted_ts = evict_ts
            fr.evicted_from = slot
            fr.evicted_kind = kind
            if _rt._enabled:
                _rt.mark(fr.rid, "evict", t=evict_ts, replica=slot,
                         kind=kind)
            requeued[fr.cls].append(fr)
        n = 0
        for cls, frs in requeued.items():
            if not self.fleet.requeue:
                # requeue disabled: the loss is SURFACED, not leaked —
                # each dropped request completes (finish_reason
                # "dropped") through the next step() return and is
                # counted, so a bench/caller can never miss it
                for fr in frs:
                    fr.finish_reason = "dropped"
                    fr.done_ts = time.perf_counter()
                    self._finished_at_eviction.append(fr)
                    self._by_rid.pop(fr.rid, None)
                    if _obs._enabled:
                        _obs.counter("serving.fleet.dropped_total",
                                     cls=cls).add(1)
                    if _rt._enabled:
                        _rt.mark(fr.rid, "drop", t=fr.done_ts, cls=cls)
                continue
            # front of the class queue, original admission order kept
            self._queues[cls][:0] = frs
            n += len(frs)
            if _obs._enabled and frs:
                # per-class requeue visibility (was only in receipt
                # extras)
                _obs.counter("serving.fleet.requeue_total",
                             cls=cls).add(len(frs))
        # flight-recorder breadcrumbs: a crash dump / tpu_doctor merge
        # must cover serving incidents like training ones (self-gated)
        _fr.record("fleet.evict", replica=slot, fault=kind,
                   tick=self._tick, requeued=n)
        if n:
            _fr.record("fleet.requeue", replica=slot, requeued=n,
                       tick=self._tick)
            self.requeued_total += n
            if _obs._enabled:
                _obs.counter("serving.evicted_total").add(n)
                _obs.counter("serving.fleet.requeued_total").add(n)
        return n

    def _autoscale(self):
        p99 = self._rolling_p99()
        d = self.policy.decide_scale(self.slo, self.queue_depth, p99,
                                     burn_alert=self._burn.alert())
        if d is None:
            return
        if d.action == "scale_up":
            slot = d.ranks[0]
            rep = self._replicas.get(slot)
            if rep is not None and rep.alive:
                # the slot is still DRAINING from an earlier
                # scale_down: cancel the drain — instant warm
                # capacity, and spawning over it would orphan its
                # in-flight requests
                rep.state = "active"
                d.reason += " (drain cancelled)"
            else:
                self._replicas[slot] = self._spawn(
                    slot, self._incarnation(slot))
                self.policy.record_scale_spawn()
        else:  # scale_down: drain, decommission once empty
            for slot in d.ranks:
                if slot in self._replicas:
                    self.drain_replica(slot)
        _fr.record("fleet.scale", action=d.action,
                   ranks=list(d.ranks), tick=self._tick)
        self._emit(action=d.action, verdict=d.verdict, ranks=d.ranks,
                   reason=d.reason, episode=d.episode,
                   extras={"queue_depth": self.queue_depth,
                           "p99_ttft_ms": p99,
                           "fleet_tick": self._tick},
                   decision_id=d.decision_id)

    def _maybe_grow(self):
        if self._aborted:
            return
        d = self.policy.maybe_grow()
        if d is None:
            return
        # maybe_grow itself books the spawns against the restart
        # window — recording them again here
        # would double-charge the budget
        for slot in d.ranks:
            self._replicas[slot] = self._spawn(
                slot, self._incarnation(slot) + 1)
        _fr.record("fleet.scale", action="grow", ranks=list(d.ranks),
                   tick=self._tick)
        self._emit(action="grow", verdict=d.verdict, ranks=d.ranks,
                   reason=d.reason, episode=d.episode,
                   decision_id=d.decision_id)

    def _dispatch(self):
        """Feed highest-priority queued requests to the least-loaded
        active replicas; local engine queues stay shallow (bounded by
        max_admit) so an eviction can only ever requeue a tick's worth
        of undispatched work."""
        targets = [r for r in self._replicas.values()
                   if r.alive and r.state == "active"]
        for cls in self.fleet.classes:
            q = self._queues[cls]
            while q:
                # least-loaded replica with local-queue room: a
                # saturated LOCAL queue must not block dispatch to a
                # sibling that still has room
                avail = [r for r in targets
                         if r.engine.sched.queue_depth
                         < self.config.max_admit]
                if not avail:
                    return      # every replica saturated this tick
                avail.sort(key=Replica.load)
                rep = avail[0]
                fr = q.pop(0)
                fr.replica = rep.slot
                if _rt._enabled:
                    now = time.perf_counter()
                    if fr.evicted_ts is not None:
                        # the requeue hop: evict -> re-dispatch (the
                        # replay's class-queue wait included)
                        _rt.record_span(
                            fr.rid, "requeue", fr.evicted_ts, now,
                            replica=rep.slot,
                            replica_from=fr.evicted_from,
                            kind=fr.evicted_kind)
                    else:
                        _rt.record_span(fr.rid, "queue", fr.arrival,
                                        now, cls=fr.cls,
                                        replica=rep.slot)
                fr.evicted_ts = None
                rep.engine.submit(
                    fr.resume_ids(), fr.remaining, rid=fr.rid,
                    eos_token_id=fr.eos_token_id, arrival=fr.arrival)

    def _step_replicas(self, now: float) -> List[FleetRequest]:
        finished: List[FleetRequest] = []
        for rep in list(self._replicas.values()):
            if not rep.alive:
                continue
            if now < rep.wedged_until:
                continue        # wedged: no step, no pulse
            rep.last_pulse_tick = self._tick
            rep.engine.trace_tick = self._tick   # reqtrace lane label
            if not rep.engine.has_work():
                if rep.state == "draining":
                    # drained: decommission (engine executables retire
                    # with it; nothing in flight by construction)
                    self._retired_recompiles += rep.engine.sentinel.fired
                    self._retired_executables += \
                        rep.engine.executable_count()
                    rep.engine.release()
                    rep.engine = None
                    self._replicas.pop(rep.slot, None)
                    self._reset_replica_gauges(rep.slot)
                continue
            for r in rep.engine.step():
                fr = self._by_rid.get(r.rid)
                if fr is None:
                    continue
                self._harvest(fr, r)
                fr.finish_reason = r.finish_reason
                fr.done_ts = r.done_ts
                fr.replica = None
                rep.finished_total += 1
                self._record_finish(fr)
                finished.append(fr)
                self._by_rid.pop(fr.rid, None)
            for r in rep.engine.sched.running.values():
                fr = self._by_rid.get(r.rid)
                if fr is not None:
                    self._harvest(fr, r)
        return finished

    def _harvest(self, fr: FleetRequest, r: Request):
        """Stream the engine request's emitted tokens up to the fleet
        — after this, a replica death costs nothing already
        harvested."""
        before = len(fr.emitted)
        fr.emitted = fr.base + [int(t) for t in r.out]
        if before == 0 and fr.emitted and fr.first_token_ts is None:
            fr.first_token_ts = r.first_token_ts or \
                time.perf_counter()
            if _obs._enabled and fr.arrival is not None:
                _obs.histogram("serving.fleet.ttft_ms",
                               cls=fr.cls).observe(
                    (fr.first_token_ts - fr.arrival) * 1e3)
        rep = self._replicas.get(fr.replica) if fr.replica is not None \
            else None
        if rep is not None:
            rep.tokens_total += len(fr.emitted) - before

    def _record_finish(self, fr: FleetRequest):
        if fr.arrival is None or fr.first_token_ts is None:
            return
        ttft = (fr.first_token_ts - fr.arrival) * 1e3
        done = fr.done_ts or time.perf_counter()
        self._window.append((done, ttft, fr.cls, len(fr.emitted)))
        if len(self._window) > self.slo.ttft_window:
            self._window = self._window[-self.slo.ttft_window:]
        self._burn.record(done, ttft > self.slo.p99_ttft_ms)

    def _rolling_p99(self) -> float:
        if not self._window:
            return -1.0
        return float(np.percentile([w[1] for w in self._window], 99))

    def _rolling_tokens_per_s(self) -> float:
        if len(self._window) < 2:
            return -1.0
        span = self._window[-1][0] - self._window[0][0]
        if span <= 0:
            return -1.0
        return sum(w[3] for w in self._window) / span

    def _reset_replica_gauges(self, slot: int):
        """A dead slot must not keep exporting its last occupancy: the
        registry is process-shared, so a frozen labeled gauge would
        ride every export after the replica is gone (reset() bypasses
        the metrics gate deliberately — same discipline as the
        checkpoint host-snapshot gauge)."""
        for name in ("serving.pages_live", "serving.pages_free",
                     "serving.pages_occupancy"):
            g = _obs.get(name, replica=slot)
            if g is not None:
                g.reset()

    def _publish(self, now: float):
        # post-signals for the outcome joiner, fed EVERY tick whether
        # or not the gauge refresh is on: the ledger's verdicts must
        # not depend on the metrics gate (decision.* series are
        # always-on for the same reason)
        if _dec.enabled():
            queued = self.queue_depth
            p99 = self._rolling_p99()
            _dec.observe("supervisor.scale",
                         {"queued": queued, "p99_ttft_ms": p99})
            _dec.observe("supervisor.remediate", {"failures": 0})
            _dec.observe("supervisor.grow", {"failures": 0})
            _dec.observe("fleet.shed", {"queued": queued})
            _dec.join_outcomes()
        if not _obs._enabled:
            # the pulse plane rides the fleet tick even when the gauge
            # refresh is off (frozen values are still a truthful flat
            # series; disabled sample() is one bool read)
            _ts.sample()
            return
        # paged-cache occupancy, sampled EVERY fleet tick (the memory
        # plane: the page invariants used to be
        # test-only — production couldn't see a leaking pool). Labeled
        # per replica (the registry is process-shared) + fleet totals.
        pages_live = pages_free = 0
        for rep in self._replicas.values():
            if rep.engine is None:
                continue
            st = rep.engine.cache.stats()
            pages_live += st["pages_live"]
            pages_free += st["pages_free"]
            _obs.gauge("serving.pages_live", replica=rep.slot).set(
                st["pages_live"])
            _obs.gauge("serving.pages_free", replica=rep.slot).set(
                st["pages_free"])
            _obs.gauge("serving.pages_occupancy",
                       replica=rep.slot).set(round(st["occupancy"], 4))
        _obs.gauge("serving.fleet.pages_live").set(pages_live)
        _obs.gauge("serving.fleet.pages_free").set(pages_free)
        _mem.sample()   # device/host occupancy rides the same tick
        _obs.gauge("serving.fleet.queue_depth").set(self.queue_depth)
        # per-class central-queue depth, sampled EVERY fleet tick (the
        # otherwise depth would be observable only at dispatch)
        for cls in self.fleet.classes:
            _obs.gauge("serving.fleet.queue_depth", cls=cls).set(
                len(self._queues[cls]))
        _obs.gauge("serving.fleet.live_replicas").set(
            len(self.live_replicas()))
        _obs.gauge("serving.fleet.p99_ttft_ms").set(
            self._rolling_p99())
        _obs.gauge("serving.fleet.tokens_per_s").set(
            self._rolling_tokens_per_s())
        for w, r in self._burn.rates(now).items():
            _obs.gauge("serving.slo.burn_rate",
                       window=f"{w:g}s").set(round(r, 4))
        _obs.gauge("serving.slo.burn_alert").set(
            1 if self._burn.alert(now) else 0)
        # pulse sample AFTER the gauge refresh so the rings carry THIS
        # tick's values (throttled to the sampler cadence internally;
        # the fleet needs no daemon thread of its own)
        _ts.sample()

    # -- receipts / rollup ----------------------------------------------------
    def _emit(self, action: str, verdict: dict, ranks: Sequence[int],
              reason: str = "", delay_s: float = 0.0,
              episode: Optional[int] = None,
              world_before: Optional[int] = None,
              extras: Optional[dict] = None,
              decision_id: Optional[str] = None):
        live = self.live_replicas()
        doc = _elastic.emit_receipt(
            episode=self.policy.episode if episode is None else episode,
            verdict=verdict, action=action, ranks=list(ranks),
            world_before=(len(live) if world_before is None
                          else int(world_before)),
            world_after=len(live), delay_s=delay_s, reason=reason,
            extras=extras, decision_id=decision_id,
            out_dir=self.fleet.receipts_dir)
        self.episodes.append(doc)
        return doc

    def recompile_events(self) -> int:
        return self._retired_recompiles + sum(
            r.engine.sentinel.fired for r in self._replicas.values()
            if r.engine is not None)

    def executable_count(self) -> int:
        return sum(r.engine.executable_count()
                   for r in self._replicas.values()
                   if r.engine is not None)

    def expected_executables(self) -> int:
        # per-engine sum, not ladder.size * live: the raw-speed levers
        # (speculative draft programs, chunk shapes, the COW copy)
        # change each engine's steady-state budget
        return sum(r.engine.expected_executables
                   for r in self._replicas.values()
                   if r.engine is not None)

    def aggregate(self, timeout_s: Optional[float] = None
                  ) -> Dict[str, dict]:
        """Fleet rollup of per-replica snapshots — skip-and-flag: a
        dead replica (snapshot raises) or an unresponsive one (no
        answer within ``timeout_s``) is SKIPPED and counted in
        ``fleet.sources_skipped`` instead of hanging or failing the
        gather (the 1-dead-of-3 contract)."""
        timeout = (self.fleet.snapshot_timeout_s if timeout_s is None
                   else float(timeout_s))
        snaps: List[Optional[dict]] = []
        for slot in sorted(self._replicas):
            snaps.append(self._snapshot_with_timeout(
                self._replicas[slot], timeout))
        merged = _obs_fleet.merge_partial(snaps)
        merged["fleet.ticks"] = {"type": "gauge", "value": self._tick}
        merged["fleet.live_replicas"] = {
            "type": "gauge", "value": len(self.live_replicas())}
        return merged

    @staticmethod
    def _snapshot_with_timeout(rep: Replica, timeout_s: float
                               ) -> Optional[dict]:
        if rep.engine is None:
            return None         # dead: no thread needed
        if getattr(rep, "_snapshot_wedged", False):
            # this replica already timed out once; don't leak another
            # blocked thread per poll — it stays skipped until the
            # Replica object is replaced
            return None
        box: Dict[str, Optional[dict]] = {"snap": None}

        def _run():
            try:
                box["snap"] = rep.snapshot()
            except Exception:
                box["snap"] = None
        t = threading.Thread(target=_run, daemon=True)
        t.start()
        t.join(timeout_s)
        if t.is_alive():
            rep._snapshot_wedged = True
        return box["snap"]      # None: dead, raised, or still hanging

    def summary(self) -> dict:
        """One receipt-shaped dict for benches/drills."""
        # close the ledger's books: anything still inside its settle
        # window joins against the freshest post-decision observation
        # (or stamps `unjoined` honestly) so the episode rollup below
        # carries final outcomes, not race results
        _dec.join_outcomes(force=True)
        per_cls = {}
        for cls in self.fleet.classes:
            ttfts = [w[1] for w in self._window if w[2] == cls]
            per_cls[cls] = {
                "finished_in_window": len(ttfts),
                "p50_ttft_ms": (round(float(np.percentile(ttfts, 50)),
                                      3) if ttfts else -1.0),
                "p99_ttft_ms": (round(float(np.percentile(ttfts, 99)),
                                      3) if ttfts else -1.0),
            }
        episodes = []
        for e in self.episodes:
            ent = {"action": e["action"],
                   "verdict": e["verdict"].get("kind"),
                   "ranks": e["ranks"], "reason": e["reason"]}
            did = e.get("decision_id")
            if did is not None:
                rec = _dec.get(did)
                ent["decision_id"] = did
                ent["outcome"] = (rec.outcome if rec is not None
                                  else None)
            episodes.append(ent)
        return {
            "ticks": self._tick,
            "live_replicas": self.live_replicas(),
            "episodes": episodes,
            "requeued_total": self.requeued_total,
            "shed_total": self.shed_total,
            "weight_swaps": self.swaps_total,
            "weight_swaps_aborted": self.swaps_aborted,
            "recompile_events": self.recompile_events(),
            "executables": self.executable_count(),
            "expected_executables": self.expected_executables(),
            "rolling_p99_ttft_ms": round(self._rolling_p99(), 3),
            "per_class_ttft": per_cls,
            "slo_burn": {f"{w:g}s": round(r, 4)
                         for w, r in self._burn.rates().items()},
            "burn_alert": self._burn.alert(),
            "aborted": self._aborted,
        }


def _to_device(tree, device):
    """A params tree (tensors, or the numpy arrays a checkpoint gives
    back) as tensors on `device`."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return (tree if isinstance(tree, torch.Tensor)
            else from_numpy(tree)).to(device)
