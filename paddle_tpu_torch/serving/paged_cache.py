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

Prefix sharing (copy-on-write). A token's K/V depends only on the
tokens before it, so a page holding a full ``block_size``-token chunk of
a prompt is reusable as it is by every request whose prompt starts with
the same tokens. With ``prefix_sharing=True`` a radix index over
full-page token chunks maps prompt prefixes to the pages that hold
their K/V, and every page carries a refcount:

- ``alloc_shared`` matches the longest indexed prefix (capped one token
  short of the prompt, so the suffix prefill keeps at least one real
  token), points the new table at the shared pages (refcount + 1) and
  takes fresh pages only for the rest;
- ``register_prefix`` (after the suffix prefill landed) adopts the
  request's full-prompt pages into the index, which holds its own
  reference, so the next request with this prefix shares them;
- ``free`` drops references; a page returns to the free list at
  refcount zero. Pages only the index holds survive their creator and
  are reclaimed least-recently-used leaf first when admission needs
  pages (``available_pages`` counts them);
- ``ensure_writable`` is the copy-on-write guard: before an in-place
  write to a page with refcount > 1 the writer gets a private copy (one
  page-copy program, captured as a CUDA graph on the card) and the
  readers keep the original bytes. The engine's writes never reach a
  shared page (shared pages hold full prompt chunks only, and writes
  start past them), so the guard is the invariant's safety net.

Invariants (check_invariants): every page's refcount equals the tables
and index nodes naming it (without sharing: no page in two live
tables), scratch never handed out, and 1 (scratch) + free + live ==
n_blocks with a shared page counted once.

Not ported yet: sharded pools (tensor parallelism, ROADMAP.md queue A
item 14c).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import dtypes as _dtypes
from ..core.place import resolve_device
from .programs import ProgramCache, copy_page_fn

__all__ = ["PagedKVCache"]


class _RadixNode:
    """One full-page chunk of an indexed prompt prefix. The path from the
    root to a node spells the token prefix; ``page`` holds that chunk's
    K/V (the index owns one refcount on it)."""
    __slots__ = ("chunk", "page", "children", "parent", "tick")

    def __init__(self, chunk: Tuple[int, ...], page: int, parent,
                 tick: int):
        self.chunk = chunk
        self.page = int(page)
        self.children: Dict[Tuple[int, ...], "_RadixNode"] = {}
        self.parent = parent
        self.tick = tick


class _RadixIndex:
    """Radix tree over ``block_size``-token chunks -> page ids, with LRU
    ticks for leaf-first reclaim."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)
        self.children: Dict[Tuple[int, ...], _RadixNode] = {}
        self._tick = 0
        self.n_nodes = 0

    def _chunks(self, ids) -> List[Tuple[int, ...]]:
        bs = self.block_size
        ids = [int(t) for t in ids]
        return [tuple(ids[i * bs:(i + 1) * bs])
                for i in range(len(ids) // bs)]

    def match(self, ids, max_pages: int) -> List[int]:
        """Longest indexed prefix of ``ids`` in full pages (<=
        max_pages); touches the matched path's LRU ticks."""
        self._tick += 1
        pages: List[int] = []
        kids = self.children
        for chunk in self._chunks(ids)[:max_pages]:
            node = kids.get(chunk)
            if node is None:
                break
            node.tick = self._tick
            pages.append(node.page)
            kids = node.children
        return pages

    def insert(self, ids, pages: Sequence[int],
               n_pages: int) -> List[int]:
        """Index the first ``n_pages`` full chunks of ``ids`` against
        ``pages``; returns the pages newly adopted (the caller owes each
        one refcount). A chunk already present keeps its page (first
        writer wins: both hold the same K/V)."""
        self._tick += 1
        adopted: List[int] = []
        parent = None
        kids = self.children
        for i, chunk in enumerate(self._chunks(ids)[:n_pages]):
            node = kids.get(chunk)
            if node is None:
                node = _RadixNode(chunk, pages[i], parent, self._tick)
                kids[chunk] = node
                self.n_nodes += 1
                adopted.append(node.page)
            else:
                node.tick = self._tick
            parent = node
            kids = node.children
        return adopted

    def pop_lru_leaf(self) -> Optional[_RadixNode]:
        """Remove and return the least recently touched leaf (reclaim
        drops subtrees leaf first, so every remaining path stays
        matchable)."""
        leaf = None
        stack = list(self.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif leaf is None or n.tick < leaf.tick:
                leaf = n
        if leaf is None:
            return None
        kids = (leaf.parent.children if leaf.parent is not None
                else self.children)
        del kids[leaf.chunk]
        self.n_nodes -= 1
        return leaf

    def pages(self) -> List[int]:
        out: List[int] = []
        stack = list(self.children.values())
        while stack:
            n = stack.pop()
            out.append(n.page)
            stack.extend(n.children.values())
        return out


class PagedKVCache:
    """Fixed page pool + host-side block-table allocator.

    ``pools`` is a tuple over layers of (k, v) page pools on ``device``
    (the current device when None: the card unless the CPU was asked
    for). Everything else is host bookkeeping."""

    def __init__(self, n_layers: int, n_blocks: int, block_size: int,
                 n_heads: int, head_dim: int, dtype="float32",
                 prefix_sharing: bool = False, pool_sharding=None,
                 tp: int = 1, device=None):
        if pool_sharding is not None or int(tp) != 1:
            raise NotImplementedError(
                "sharded page pools (pool_sharding, tp > 1) are not ported "
                "yet: they come with ROADMAP.md queue A item 14c (tp "
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
        # page -> refcount over live pages (tables + index holds; 1 each
        # without sharing, so n_live and conservation are one code path)
        self._ref: Dict[int, int] = {}
        self.prefix_sharing = bool(prefix_sharing)
        self._radix = (_RadixIndex(self.block_size)
                       if self.prefix_sharing else None)
        # the copy-on-write page copy, captured on first use (warm_copy)
        self._copy = ProgramCache(self.device)
        # sharing receipts (host counters)
        self.prefix_hits = 0
        self.shared_pages_matched = 0
        self.cow_copies = 0
        self.reclaimed_pages = 0

    # -- sizing --------------------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        """Pages needed to hold n_tokens."""
        return -(-int(n_tokens) // self.block_size)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        """Distinct live pages: a page shared by several tables (and/or
        the prefix index) counts once; conservation is ``1 + n_free +
        n_live == n_blocks``."""
        return len(self._ref)

    @property
    def n_shared(self) -> int:
        return sum(1 for c in self._ref.values() if c > 1)

    def _n_reclaimable(self) -> int:
        """Index-held pages no live table references: droppable by LRU
        reclaim, so admission may count them as allocatable."""
        if self._radix is None:
            return 0
        return sum(1 for p in self._radix.pages()
                   if self._ref.get(p, 0) == 1)

    @property
    def available_pages(self) -> int:
        """Free pages plus index-only (reclaimable) ones: the number
        admission control may promise."""
        return len(self._free) + self._n_reclaimable()

    def can_alloc(self, n_tokens: int) -> bool:
        return self.blocks_for(n_tokens) <= self.available_pages

    @property
    def pool_bytes(self) -> int:
        """Device bytes the pools hold, fixed at build."""
        return sum(t.numel() * t.element_size()
                   for kv in self.pools for t in kv)

    def stats(self) -> Dict[str, float]:
        """Occupancy snapshot: pages live/free/scratch (live + free + 1
        == n_blocks, live counting a shared page once), occupancy of the
        allocatable pool, live requests and the pools' device bytes;
        with sharing also the sharing receipts."""
        allocatable = self.n_blocks - 1
        live = self.n_live
        out = {
            "pages_live": live,
            "pages_free": len(self._free),
            "pages_scratch": 1,
            "occupancy": (live / allocatable) if allocatable else 0.0,
            "requests": len(self._tables),
            "pool_bytes": self.pool_bytes,
        }
        if self.prefix_sharing:
            out.update({
                "pages_shared": self.n_shared,
                "prefix_nodes": self._radix.n_nodes,
                "prefix_hits": self.prefix_hits,
                "shared_pages_matched": self.shared_pages_matched,
                "cow_copies": self.cow_copies,
                "reclaimed_pages": self.reclaimed_pages,
            })
        return out

    # -- page bookkeeping ----------------------------------------------------
    def _take_pages(self, need: int, who) -> List[int]:
        """Pop ``need`` fresh pages (refcount 1 each), reclaiming
        index-only pages least-recently-used leaf first when the free
        list runs short."""
        if need > len(self._free):
            self._reclaim(need - len(self._free))
        if need > len(self._free):
            raise MemoryError(
                f"paged cache exhausted: need {need} pages for "
                f"{who!r}, {len(self._free)} free "
                f"(pool {self.n_blocks - 1} allocatable)")
        pages = [self._free.pop() for _ in range(need)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def _decref(self, page: int) -> int:
        """Drop one reference; returns 1 when the page went back to the
        free list."""
        c = self._ref[page] - 1
        if c:
            self._ref[page] = c
            return 0
        del self._ref[page]
        self._free.append(page)
        return 1

    def _reclaim(self, shortfall: int):
        """Evict least recently used index leaves until ``shortfall``
        pages came free (or the index has no leaf left). Dropping a leaf
        whose page a live table still shares frees nothing now (the page
        returns when the request retires), so the loop counts only real
        free-list gains."""
        if self._radix is None:
            return
        freed = 0
        while freed < shortfall:
            leaf = self._radix.pop_lru_leaf()
            if leaf is None:
                break
            got = self._decref(leaf.page)
            freed += got
            self.reclaimed_pages += got

    # -- allocate / free -----------------------------------------------------
    def alloc(self, req_id, n_tokens: int) -> List[int]:
        """Reserve the request's whole-lifetime page list. Raises on
        double-alloc or pool exhaustion (admission control checks
        ``can_alloc`` first: running out mid-decode is a bug)."""
        if req_id in self._tables:
            raise ValueError(f"request {req_id!r} already holds pages")
        blocks = self._take_pages(self.blocks_for(n_tokens), req_id)
        self._tables[req_id] = blocks
        return list(blocks)

    def alloc_shared(self, req_id, n_tokens: int,
                     prompt_ids) -> Tuple[List[int], int]:
        """Prefix-sharing admission: match the longest indexed prefix of
        ``prompt_ids`` (full pages only, capped one token short of the
        prompt so the suffix prefill keeps at least one real token),
        share those pages (refcount + 1) and take fresh pages for the
        rest of the whole-lifetime reservation. Returns ``(blocks,
        shared_tokens)``."""
        if self._radix is None:
            raise RuntimeError("prefix_sharing is disabled on this cache")
        if req_id in self._tables:
            raise ValueError(f"request {req_id!r} already holds pages")
        cap = (len(prompt_ids) - 1) // self.block_size
        shared = self._radix.match(prompt_ids, cap)
        fresh = self._take_pages(self.blocks_for(n_tokens) - len(shared),
                                 req_id)
        for p in shared:
            self._ref[p] += 1
        self._tables[req_id] = list(shared) + fresh
        if shared:
            self.prefix_hits += 1
            self.shared_pages_matched += len(shared)
        return list(self._tables[req_id]), len(shared) * self.block_size

    def register_prefix(self, req_id, prompt_ids) -> int:
        """Adopt the request's full-prompt-chunk pages into the radix
        index (call after its prefill landed: the pages must hold real
        K/V). The index takes its own refcount on each newly adopted
        page, so they outlive the request. Returns the number adopted."""
        if self._radix is None:
            return 0
        table = self._tables[req_id]
        full = len(prompt_ids) // self.block_size
        adopted = self._radix.insert(prompt_ids, table, full)
        for p in adopted:
            self._ref[p] += 1
        return len(adopted)

    def free(self, req_id) -> List[int]:
        """Drop a finished request's references; pages return to the
        free list at refcount zero, shared pages stay live for their
        other holders."""
        blocks = self._tables.pop(req_id, None)
        if blocks is None:
            raise KeyError(f"request {req_id!r} holds no pages")
        for p in blocks:
            self._decref(p)
        return blocks

    def table(self, req_id) -> List[int]:
        return list(self._tables[req_id])

    def live_requests(self) -> List:
        return list(self._tables)

    # -- copy-on-write -------------------------------------------------------
    def _copy_page(self, src: int, dst: int):
        self._copy("copy", copy_page_fn, self.pools, None,
                   (np.array([src]), np.array([dst])))

    def copy_executables(self) -> int:
        """Programs of the page copy (0 or 1: it has one shape)."""
        return len(self._copy)

    def warm_copy(self):
        """Capture the page-copy program up front (scratch into scratch
        is a harmless write), so a first real copy captures nothing
        mid-traffic."""
        self._copy_page(0, 0)
        return self

    def ensure_writable(self, req_id, first_pos: int, n_pos: int) -> int:
        """Copy-on-write guard: before in-place writes to logical
        positions ``[first_pos, first_pos + n_pos)``, give the writer a
        private copy of any covered page with refcount > 1; the readers
        (other tables, the index) keep the original bytes. Returns the
        number of pages copied (0 on the engine's write patterns)."""
        if n_pos < 1:
            return 0
        table = self._tables[req_id]
        bs = self.block_size
        copies = 0
        last = min((first_pos + n_pos - 1) // bs, len(table) - 1)
        for idx in range(first_pos // bs, last + 1):
            pid = table[idx]
            if self._ref.get(pid, 0) > 1:
                new = self._take_pages(1, req_id)[0]
                self._copy_page(pid, new)
                self._decref(pid)
                table[idx] = new
                copies += 1
        self.cow_copies += copies
        return copies

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
        """Refcount conservation and scratch never handed out. Without
        sharing no page is in two live tables; with sharing every page's
        refcount equals the tables plus index nodes naming it, and a
        shared page counts once in the live total. Cheap enough to call
        every scheduler step in tests."""
        counts: Dict[int, int] = {}
        for t in self._tables.values():
            for p in t:
                counts[p] = counts.get(p, 0) + 1
        if not self.prefix_sharing and any(c > 1 for c in counts.values()):
            raise AssertionError("a page is shared by two live requests")
        if self._radix is not None:
            idx_pages = self._radix.pages()
            if len(idx_pages) != len(set(idx_pages)):
                raise AssertionError("a page is held by two radix nodes")
            for p in idx_pages:
                counts[p] = counts.get(p, 0) + 1
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
