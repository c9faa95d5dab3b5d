"""Continuous-batching scheduler: FIFO admission into running decode
steps, retirement at token boundaries (counterpart of
paddle_tpu/serving/scheduler.py, the same behaviour).

The host-side half of the serving engine. State machine per request:

  QUEUED --admit (slots + pages available)--> RUNNING
  RUNNING --max_new reached | eos emitted--> FINISHED (pages freed)

Admission happens between decode steps (the running batch is never
drained to let newcomers in), strictly FIFO: the head of the queue
blocks admission when it does not fit, rather than letting small
requests starve a big one. Page accounting is whole-lifetime at
admission (see paged_cache), so admission control is the single
backpressure point and a running request can never run out of pages.

The bucket ladder quantizes dynamic shapes into the fixed program set:
prompts pad to the smallest prefill bucket that fits the longest prompt
in the admit batch, decode runs at the smallest slot-count bucket
covering the active set. The program count is therefore bounded by the
ladder size, not by the length mix of the traffic. With the request
tracer armed (observability.reqtrace), submit stamps the queue entry and
admission records each admitted request's ``admission`` span.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..observability import reqtrace as _rt

__all__ = ["Request", "BucketLadder", "FifoScheduler"]

_rid_counter = itertools.count()


@dataclass
class Request:
    """One generation request plus its runtime state."""
    ids: np.ndarray                    # 1-D int32 true prompt
    max_new_tokens: int
    rid: object = None
    eos_token_id: Optional[int] = None
    arrival: Optional[float] = None    # perf_counter() timestamp
    submit_ts: Optional[float] = None  # engine-queue entry (reqtrace)
    # -- runtime (engine-owned) ---------------------------------------------
    pos: int = 0                       # next K/V write position
    out: List[int] = field(default_factory=list)
    shared_tokens: int = 0             # prompt head served from shared
    #                                    pages (prefix-sharing admission)
    admitted_ts: Optional[float] = None
    first_token_ts: Optional[float] = None
    done_ts: Optional[float] = None
    finish_reason: Optional[str] = None

    def __post_init__(self):
        self.ids = np.asarray(self.ids, np.int32).reshape(-1)
        if self.ids.size < 1:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={self.max_new_tokens} must be >= 1")
        if self.rid is None:
            self.rid = next(_rid_counter)

    @property
    def prompt_len(self) -> int:
        return int(self.ids.size)

    @property
    def total_tokens(self) -> int:
        return self.prompt_len + int(self.max_new_tokens)

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    def accept(self, tok: int):
        """Record one emitted token; flip to FINISHED on budget or eos.
        The engine calls this once per token boundary."""
        self.out.append(int(tok))
        if (self.eos_token_id is not None
                and int(tok) == int(self.eos_token_id)):
            self.finish_reason = "eos"
        elif len(self.out) >= self.max_new_tokens:
            self.finish_reason = "length"


class BucketLadder:
    """The fixed shape ladder: prefill widths (multiples of block_size,
    ascending) and decode slot-count buckets."""

    def __init__(self, prefill: Sequence[int], decode: Sequence[int],
                 block_size: int):
        self.prefill = tuple(sorted(int(b) for b in prefill))
        self.decode = tuple(sorted(int(b) for b in decode))
        if not self.prefill or not self.decode:
            raise ValueError("empty bucket ladder")
        for b in self.prefill:
            if b < 1 or b % block_size:
                raise ValueError(
                    f"prefill bucket {b} must be a positive multiple "
                    f"of block_size {block_size}")
        if any(b < 1 for b in self.decode):
            raise ValueError(f"decode buckets {self.decode} must be "
                             ">= 1")

    def pick_prefill(self, length: int) -> int:
        for b in self.prefill:
            if b >= length:
                return b
        raise ValueError(
            f"prompt length {length} exceeds the largest prefill "
            f"bucket {self.prefill[-1]}")

    def pick_decode(self, n_active: int) -> int:
        for b in self.decode:
            if b >= n_active:
                return b
        raise ValueError(
            f"{n_active} active slots exceed the largest decode "
            f"bucket {self.decode[-1]}")

    @property
    def size(self) -> int:
        """Total program budget: the steady-state count the sentinel
        holds the engine to."""
        return len(self.prefill) + len(self.decode)


class FifoScheduler:
    """Queue + running set with strict-FIFO admission."""

    def __init__(self, max_slots: int, max_admit: int):
        if max_admit < 1 or max_slots < 1:
            raise ValueError("max_slots and max_admit must be >= 1")
        if max_admit > max_slots:
            raise ValueError(
                f"max_admit={max_admit} > max_slots={max_slots}")
        self.max_slots = int(max_slots)
        self.max_admit = int(max_admit)
        self.queue: deque = deque()
        self.running: dict = {}

    def submit(self, req: Request):
        if _rt._enabled:
            req.submit_ts = time.perf_counter()
        self.queue.append(req)
        return req.rid

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def n_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.queue or self.running)

    def take_admissible(self, cache, extra_caches=()) -> List[Request]:
        """Pop the FIFO prefix that fits this token boundary: bounded by
        free slots, the admit width, and page availability
        (whole-lifetime pages per request, accounted cumulatively across
        the batch). Stops at the first request that does not fit: no
        overtaking, no starvation.

        ``extra_caches`` (the speculative draft's page pool) must fit
        every admitted request too: the draft cache tracks the target
        position for position, so a request admitted into one but not
        the other would wedge mid-decode. Availability counts the prefix
        index's reclaimable pages (``available_pages``); the count is
        conservative under sharing, where a prefix hit needs fewer fresh
        pages than budgeted here."""
        caches = (cache,) + tuple(extra_caches)
        admitted: List[Request] = []
        spoken_for = [0] * len(caches)
        while (self.queue
               and len(admitted) < self.max_admit
               and self.n_running + len(admitted) < self.max_slots):
            head = self.queue[0]
            if any(taken + c.blocks_for(head.total_tokens)
                   > c.available_pages
                   for taken, c in zip(spoken_for, caches)):
                break
            for i, c in enumerate(caches):
                spoken_for[i] += c.blocks_for(head.total_tokens)
            admitted.append(self.queue.popleft())
        for r in admitted:
            self.running[r.rid] = r
        if _rt._enabled and admitted:
            now = time.perf_counter()
            for r in admitted:
                _rt.record_span(
                    r.rid, "admission",
                    now if r.submit_ts is None else r.submit_ts, now)
        return admitted

    def retire_finished(self) -> List[Request]:
        done = [r for r in self.running.values() if r.done]
        for r in done:
            del self.running[r.rid]
        return done

    def active(self) -> List[Request]:
        return [r for r in self.running.values() if not r.done]
