"""Block/paged KV cache: a fixed pool of pages + host-side block tables
(counterpart of paddle_tpu/serving/paged_cache.py).

- device side: per layer, one K pool and one V pool of shape
  ``[n_blocks, block_size, n_heads, head_dim]``, allocated once at
  engine build. The programs (serving/programs.py) write K/V into them
  in place; they are never reallocated, because every captured CUDA
  graph holds their addresses;
- host side: a LIFO free list and a per-request block table (request ->
  ordered page ids). Logical token position ``p`` of a request lives in
  page ``table[p // block_size]`` at offset ``p % block_size``.

Freeing a finished request is a host-side list append: no device copy,
no neighbour movement, no new program. Block id 0 is reserved as
SCRATCH: it is never allocated, and masked or padded rows in the
programs write there, so inactive lanes need no conditional scatter.

Allocation is whole-lifetime: ``alloc(req, prompt + max_new)`` reserves
every page the request can ever touch at admission, so a running decode
can never run out of pages (admission control is the only backpressure
point).

Invariants (check_invariants): no page in two live tables, per-page
refcounts equal the tables naming the page, scratch never handed out,
and 1 (scratch) + free + live == n_blocks.

Not ported yet: prefix sharing (the radix index and the copy-on-write
page copy, ROADMAP.md queue A item 11) and sharded pools (tensor
parallelism, item 14).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..core import dtypes as _dtypes
from ..core.place import resolve_device

__all__ = ["PagedKVCache"]


class PagedKVCache:
    """Fixed page pool + host-side block-table allocator.

    ``pools`` is a tuple over layers of (k, v) page pools on ``device``
    (the current device when None: the card unless the CPU was asked
    for). Everything else is host bookkeeping."""

    def __init__(self, n_layers: int, n_blocks: int, block_size: int,
                 n_heads: int, head_dim: int, dtype="float32",
                 prefix_sharing: bool = False, pool_sharding=None,
                 tp: int = 1, device=None):
        if prefix_sharing:
            raise NotImplementedError(
                "prefix_sharing is not ported yet: the radix index and "
                "copy-on-write pages come with ROADMAP.md queue A item 11")
        if pool_sharding is not None or int(tp) != 1:
            raise NotImplementedError(
                "sharded page pools (pool_sharding, tp > 1) are not ported "
                "yet: they come with ROADMAP.md queue A item 14 (tp "
                "serving)")
        if n_blocks < 2:
            raise ValueError(
                f"n_blocks={n_blocks}: need at least 1 allocatable "
                "page beyond the reserved scratch block 0")
        if block_size < 1:
            raise ValueError(f"block_size={block_size} must be >= 1")
        self.n_layers = int(n_layers)
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.n_heads = int(n_heads)
        self.head_dim = int(head_dim)
        self.dtype = _dtypes.convert_dtype(dtype)
        self.device = resolve_device(device)
        shape = (self.n_blocks, self.block_size, self.n_heads,
                 self.head_dim)
        self.pools = tuple(
            (torch.zeros(shape, dtype=self.dtype, device=self.device),
             torch.zeros(shape, dtype=self.dtype, device=self.device))
            for _ in range(self.n_layers))
        # LIFO free list: hot reuse keeps the working set of pages small
        # (freshly freed pages go to the next admission)
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._tables: Dict[object, List[int]] = {}
        # page -> refcount over live pages (1 each without sharing)
        self._ref: Dict[int, int] = {}

    # -- sizing --------------------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        """Pages needed to hold n_tokens."""
        return -(-int(n_tokens) // self.block_size)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        """Live pages; conservation is 1 + n_free + n_live == n_blocks."""
        return len(self._ref)

    @property
    def available_pages(self) -> int:
        """The pages admission control may promise (the free list)."""
        return len(self._free)

    def can_alloc(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= self.available_pages

    @property
    def pool_bytes(self) -> int:
        """Device bytes the pools hold, fixed at build."""
        return sum(t.numel() * t.element_size()
                   for kv in self.pools for t in kv)

    # -- allocate / free -----------------------------------------------------
    def alloc(self, req_id, n_tokens: int) -> List[int]:
        """Reserve the request's whole-lifetime page list. Raises on
        double-alloc or pool exhaustion (admission control checks
        ``can_alloc`` first: running out mid-decode is a bug)."""
        if req_id in self._tables:
            raise ValueError(f"request {req_id!r} already holds pages")
        need = self.blocks_for(n_tokens)
        if need > len(self._free):
            raise MemoryError(
                f"paged cache exhausted: need {need} pages for "
                f"{req_id!r}, {len(self._free)} free "
                f"(pool {self.n_blocks - 1} allocatable)")
        blocks = [self._free.pop() for _ in range(need)]
        for p in blocks:
            self._ref[p] = 1
        self._tables[req_id] = blocks
        return list(blocks)

    def free(self, req_id) -> List[int]:
        """Return a finished request's pages to the free list."""
        blocks = self._tables.pop(req_id, None)
        if blocks is None:
            raise KeyError(f"request {req_id!r} holds no pages")
        for p in blocks:
            del self._ref[p]
            self._free.append(p)
        return blocks

    # -- program feed --------------------------------------------------------
    def table_array(self, req_ids: Sequence, width: int) -> np.ndarray:
        """Padded ``[len(req_ids), width]`` int32 block-table array for
        the programs. Missing entries (rows shorter than width, or
        req_id None = a dummy lane) point at the scratch block 0: writes
        land there, reads are masked."""
        out = np.zeros((len(req_ids), width), np.int32)
        for i, rid in enumerate(req_ids):
            if rid is None:
                continue
            blocks = self._tables[rid]
            if len(blocks) > width:
                raise ValueError(
                    f"request {rid!r} holds {len(blocks)} pages > "
                    f"table width {width}")
            out[i, :len(blocks)] = blocks
        return out

    # -- invariants ----------------------------------------------------------
    def check_invariants(self):
        """Refcount conservation and scratch never handed out. Cheap
        enough to call every scheduler step in tests."""
        counts: Dict[int, int] = {}
        for t in self._tables.values():
            for p in t:
                counts[p] = counts.get(p, 0) + 1
        if any(c > 1 for c in counts.values()):
            raise AssertionError("a page is shared by two live requests")
        if counts != self._ref:
            raise AssertionError(
                f"refcounts drifted: expected {counts}, "
                f"cache holds {self._ref}")
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise AssertionError("duplicate page on the free list")
        if set(counts) & free_set:
            raise AssertionError("page both live and free")
        if 0 in counts or 0 in free_set:
            raise AssertionError("scratch block 0 was allocated")
        total = 1 + len(self._free) + len(counts)
        if total != self.n_blocks:
            raise AssertionError(
                f"page conservation broken: 1 scratch + "
                f"{len(self._free)} free + {len(counts)} live != "
                f"{self.n_blocks}")
        return True
