"""paddle_tpu_torch.serving: the continuous-batching inference path
(counterpart of paddle_tpu/serving, its baseline configuration).

  paged_cache  fixed pool of [n_blocks, block_size, n_heads, hd] K/V
               pages per layer + host block tables and a LIFO free list
  programs     bucketed prefill and the paged decode chunk, held in a
               per-engine ProgramCache: one CUDA graph per bucket on
               the card, the eager function on the CPU
  scheduler    FIFO continuous batching: admit/retire at token
               boundaries, whole-lifetime page reservation
  engine       ServingEngine: bf16 by default, an f32 parity mode held
               token for token against models/generation.py greedy

Not ported yet (ROADMAP.md queue A): the chunk program, int8,
speculative decoding, prefix sharing, loadgen, the fleet, tp serving.
"""
from .engine import ServingConfig, ServingEngine, build_serving_snapshot
from .paged_cache import PagedKVCache
from .programs import ProgramCache, make_decode_fn, make_prefill_fn
from .scheduler import BucketLadder, FifoScheduler, Request

__all__ = ["ServingConfig", "ServingEngine", "build_serving_snapshot",
           "PagedKVCache", "ProgramCache", "make_decode_fn",
           "make_prefill_fn", "BucketLadder", "FifoScheduler", "Request"]
