"""paddle_tpu_torch.serving: the continuous-batching inference path
(counterpart of paddle_tpu/serving).

  paged_cache  fixed pool of [n_blocks, block_size, n_heads, hd] K/V
               pages per layer + host block tables, a LIFO free list,
               and (prefix_sharing=True) a radix index over full prompt
               pages with refcounted copy-on-write pages
  programs     bucketed prefill, the paged decode chunk and the paged
               multi-token chunk (speculative verify, shared-prefix
               suffix prefill), held in a per-engine ProgramCache: one
               CUDA graph per bucket on the card, the eager function on
               the CPU
  scheduler    FIFO continuous batching: admit/retire at token
               boundaries, whole-lifetime page reservation (across the
               draft's cache too)
  engine       ServingEngine: bf16 by default, an f32 parity mode held
               token for token against models/generation.py greedy;
               int8 weights, speculative decoding and prefix sharing
  fleet        ServingFleet: N self-healing replicas behind one priority
               queue (exact requeue, SLO autoscale, hot weight swap)
  loadgen      open-loop trace replays (engine, fleet, static batches)
               and their SLO summary

Not ported yet (ROADMAP.md queue A): tp serving (14).
"""
from . import loadgen
from .engine import ServingConfig, ServingEngine, build_serving_snapshot
from .fleet import (PRIORITY_CLASSES, FleetConfig, FleetRequest,
                    Replica, ServingFleet, ServingSLO)
from .paged_cache import PagedKVCache
from .programs import (ProgramCache, make_chunk_fn, make_decode_fn,
                       make_prefill_fn)
from .scheduler import BucketLadder, FifoScheduler, Request

__all__ = ["ServingConfig", "ServingEngine", "build_serving_snapshot",
           "PagedKVCache", "ProgramCache", "make_chunk_fn", "make_decode_fn",
           "make_prefill_fn", "BucketLadder", "FifoScheduler", "Request",
           "ServingSLO", "FleetConfig", "FleetRequest", "Replica",
           "ServingFleet", "PRIORITY_CLASSES"]
