"""Open-loop load generator and SLO accounting (counterpart of
paddle_tpu/serving/loadgen.py).

Open loop: arrivals follow the trace's clock, not the server's, so a
slow server grows its queue instead of slowing the offered load (a
closed loop lets the server set the pace and overstates throughput).

Three replays of one trace:

- ``replay_continuous``: the ServingEngine loop: submit what has
  arrived, step one token boundary, repeat. TTFT is the first token's
  wall time less the trace arrival (queueing counts).
- ``replay_fleet``: the same over a ServingFleet, each request with its
  priority class; shed requests are counted apart from drops.
- ``replay_static``: the baseline: fixed-size batches through the
  model's ``generate`` (a dense per-call KV cache, ragged prompts through
  prompt_lens). A batch forms when enough requests wait (head of line);
  every prompt is padded to the batch's longest and every row decodes
  the batch's largest budget. Where the JAX package compiles one
  executable per new (batch, prompt_pad, new_tokens) signature, the port
  captures one new program (CUDA graphs) per signature in the model's
  ProgramLRU on the card; ``compiled_signatures`` counts the signatures
  and ``program_captures`` the programs this replay captured (0 once a
  warm run has captured them all; 0 on the CPU, where generate runs its
  eager loop). Short batches repeat their last request, so the batch dim
  stays signature-stable.

Every replay credits USEFUL tokens only (each request's own budget):
the static path's decode past a row's budget is not credited.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["TraceItem", "synthetic_trace", "replay_continuous",
           "replay_fleet", "replay_static", "summarize"]


@dataclass(frozen=True)
class TraceItem:
    arrival_s: float          # offset from the trace's start
    ids: np.ndarray           # 1-D int32 prompt
    max_new_tokens: int
    cls: str = "interactive"  # priority class (fleet replays only)


def synthetic_trace(n_requests: int, vocab_size: int, seed: int = 0,
                    rate_rps: float = 50.0,
                    prompt_len_choices: Sequence[int] = (
                        4, 6, 8, 12, 16, 24, 40),
                    new_token_choices: Sequence[int] = (
                        4, 8, 12, 16, 24, 32),
                    class_mix: Optional[Dict[str, float]] = None,
                    shared_prefix_len: int = 0,
                    shared_frac: float = 0.0) -> List[TraceItem]:
    """Deterministic mixed-length Poisson arrivals: exponential
    inter-arrival times at ``rate_rps``, prompt and budget lengths drawn
    uniformly from the choice sets, all from one
    np.random.RandomState(seed) in the JAX package's order, so both
    packages give the same trace field for field. ``class_mix``
    ({class: weight}) tags each request with a priority class.

    With ``shared_prefix_len > 0`` a ``shared_frac`` fraction of the
    requests prepend one trace-wide prefix of that length to their own
    drawn tail (the system-prompt shape); size prefill buckets for
    ``shared_prefix_len + tail``."""
    rng = np.random.RandomState(seed)
    shared_ids = (rng.randint(0, vocab_size,
                              (int(shared_prefix_len),)).astype(np.int32)
                  if shared_prefix_len > 0 else None)
    classes, weights = None, None
    if class_mix:
        classes = list(class_mix)
        w = np.asarray([float(class_mix[c]) for c in classes])
        weights = w / w.sum()
    t = 0.0
    out: List[TraceItem] = []
    for _ in range(int(n_requests)):
        t += float(rng.exponential(1.0 / float(rate_rps)))
        L = int(rng.choice(list(prompt_len_choices)))
        N = int(rng.choice(list(new_token_choices)))
        ids = rng.randint(0, vocab_size, (L,)).astype(np.int32)
        if shared_ids is not None and rng.rand() < float(shared_frac):
            ids = np.concatenate([shared_ids, ids])
        cls = (str(rng.choice(classes, p=weights)) if classes
               else "interactive")
        out.append(TraceItem(arrival_s=t, ids=ids, max_new_tokens=N,
                             cls=cls))
    return out


@dataclass
class _Record:
    arrival: float            # absolute perf_counter
    first_token: float
    done: float
    n_tokens: int
    cls: Optional[str] = None  # priority class (fleet replays)


def _percentiles(vals: Sequence[float]) -> Dict[str, float]:
    if not vals:
        return {"p50": -1.0, "p99": -1.0}
    return {"p50": round(float(np.percentile(vals, 50)), 3),
            "p99": round(float(np.percentile(vals, 99)), 3)}


def summarize(records: List[_Record]) -> Dict:
    """Trace-level SLO stats: useful tokens/s over first arrival to last
    completion, and TTFT and per-token percentiles in ms.
    ``per_token_ms`` is the stream rate (first token to done over the
    tokens after the first; ~0 for the static path, whose output lands
    at once and whose cost shows in TTFT); ``request_ms_per_token`` is
    the end-to-end figure (queueing, prefill and decode, per token)."""
    if not records:
        return {"sustained_tokens_per_sec": 0.0, "requests": 0}
    t_start = min(r.arrival for r in records)
    t_end = max(r.done for r in records)
    total_tokens = sum(r.n_tokens for r in records)
    ttft_ms = [(r.first_token - r.arrival) * 1e3 for r in records]
    per_tok_ms = [(r.done - r.first_token) * 1e3
                  / max(1, r.n_tokens - 1) for r in records]
    req_tok_ms = [(r.done - r.arrival) * 1e3 / r.n_tokens
                  for r in records]
    span = max(t_end - t_start, 1e-9)
    out = {
        "requests": len(records),
        "total_new_tokens": int(total_tokens),
        "span_s": round(span, 3),
        "sustained_tokens_per_sec": round(total_tokens / span, 1),
        "ttft_ms": _percentiles(ttft_ms),
        "per_token_ms": _percentiles(per_tok_ms),
        "request_ms_per_token": _percentiles(req_tok_ms),
    }
    classes = sorted({r.cls for r in records if r.cls is not None})
    if classes:
        out["per_class_ttft_ms"] = {
            c: dict(_percentiles(
                [(r.first_token - r.arrival) * 1e3
                 for r in records if r.cls == c]),
                requests=sum(1 for r in records if r.cls == c))
            for c in classes}
    return out


def replay_continuous(engine, trace: List[TraceItem]) -> Dict:
    """Drive a ServingEngine through the trace open loop on the wall
    clock. Returns summarize()'s stats and the engine's program receipt
    (executables, expected_executables, recompile_events) and its peak
    of live pages."""
    t0 = time.perf_counter()
    next_i = 0
    records: List[_Record] = []
    peak_pages_live = 0
    while next_i < len(trace) or engine.has_work():
        now = time.perf_counter() - t0
        while next_i < len(trace) and trace[next_i].arrival_s <= now:
            it = trace[next_i]
            engine.submit(it.ids, it.max_new_tokens,
                          arrival=t0 + it.arrival_s)
            next_i += 1
        if engine.has_work():
            for r in engine.step():
                records.append(_Record(
                    arrival=r.arrival, first_token=r.first_token_ts,
                    done=r.done_ts, n_tokens=len(r.out)))
            peak_pages_live = max(peak_pages_live, engine.cache.n_live)
        elif next_i < len(trace):
            # idle until the next arrival: sleep the gap, no busy poll
            time.sleep(max(trace[next_i].arrival_s - now, 0.0))
    stats = summarize(records)
    stats["executables"] = engine.executable_count()
    stats["expected_executables"] = engine.expected_executables
    stats["recompile_events"] = engine.sentinel.fired
    stats["peak_pages_live"] = peak_pages_live
    return stats


def replay_fleet(fleet, trace: List[TraceItem], on_tick=None):
    """Drive a ServingFleet through the trace open loop. Arrivals are
    submitted with their class; shed requests are counted apart (an
    admission outcome, not a drop). ``on_tick(tick, fleet)`` runs after
    every fleet tick (the hook chaos and swap drills act through).
    Returns ``(stats, finished, shed)``: summarize()'s stats with the
    fleet's summary, and the finished and shed FleetRequests (kept out
    of the stats, which stay JSON-safe)."""
    t0 = time.perf_counter()
    next_i = 0
    finished = []
    shed = []
    while next_i < len(trace) or fleet.has_work():
        now = time.perf_counter() - t0
        while next_i < len(trace) and trace[next_i].arrival_s <= now:
            it = trace[next_i]
            fr = fleet.submit(it.ids, it.max_new_tokens, cls=it.cls,
                              arrival=t0 + it.arrival_s)
            if fr.shed:
                shed.append(fr)
            next_i += 1
        if fleet.has_work():
            finished.extend(fleet.step())
            if fleet.wedged:
                raise RuntimeError(
                    "replay_fleet: fleet aborted with queued work and "
                    "zero live replicas (restart budgets exhausted)")
            if on_tick is not None:
                on_tick(fleet._tick, fleet)
        elif next_i < len(trace):
            time.sleep(max(trace[next_i].arrival_s - now, 0.0))
    # only completed requests feed the latency stats; a requeue=False
    # fleet reports its losses as finish_reason "dropped"
    dropped = [fr for fr in finished if fr.finish_reason == "dropped"]
    records = [
        _Record(arrival=fr.arrival, first_token=fr.first_token_ts,
                done=fr.done_ts, n_tokens=len(fr.emitted), cls=fr.cls)
        for fr in finished
        if fr.finish_reason in ("length", "eos")
        and fr.first_token_ts is not None and fr.done_ts is not None]
    stats = summarize(records)
    stats["shed"] = len(shed)
    stats["dropped_requests"] = len(dropped)
    stats["fleet"] = fleet.summary()
    return stats, finished, shed


def replay_static(model, trace: List[TraceItem], batch_size: int = 4,
                  dtype: Optional[str] = None) -> Dict:
    """The static-batch baseline over the same trace: accumulate
    arrivals and serve fixed-size batches through ``model.generate`` on
    the model's device (ragged prompts through prompt_lens)."""
    from ..models.generation import generate_programs

    dev = next(model.parameters()).device
    programs = generate_programs(model)
    captures0 = programs.captures
    t0 = time.perf_counter()
    next_i = 0
    waiting: List[TraceItem] = []
    records: List[_Record] = []
    signatures = set()
    while next_i < len(trace) or waiting:
        now = time.perf_counter() - t0
        while next_i < len(trace) and trace[next_i].arrival_s <= now:
            waiting.append(trace[next_i])
            next_i += 1
        if not waiting or (len(waiting) < batch_size
                           and next_i < len(trace)):
            # no batch yet (both arms mean arrivals remain): sleep to
            # the next one
            time.sleep(max(trace[next_i].arrival_s - now, 0.0))
            continue
        take = waiting[:batch_size]
        del waiting[:len(take)]
        rows = list(take)
        while len(rows) < batch_size:      # a signature-stable batch dim
            rows.append(take[-1])
        P = max(r.ids.size for r in rows)
        N = max(r.max_new_tokens for r in rows)
        ids = np.zeros((batch_size, P), np.int32)
        lens = np.zeros((batch_size,), np.int32)
        for i, r in enumerate(rows):
            ids[i, :r.ids.size] = r.ids
            lens[i] = r.ids.size
        signatures.add((batch_size, P, N))
        out = model.generate(
            torch.from_numpy(ids).to(dev), max_new_tokens=N, dtype=dtype,
            prompt_lens=torch.from_numpy(lens).to(dev))
        out[:1, :1].cpu()              # the sync: the batch has landed
        done = time.perf_counter()
        for r in take:
            records.append(_Record(
                arrival=t0 + r.arrival_s, first_token=done, done=done,
                n_tokens=r.max_new_tokens))
    stats = summarize(records)
    stats["compiled_signatures"] = len(signatures)
    stats["program_captures"] = programs.captures - captures0
    return stats
